"""The PyTorch port's primitives and kernel wrappers held against the JAX
package on the CPU (float32, numpy-seeded inputs).

Tolerances: single float32 ops agree to the last few ulps (the two
frameworks sum in different orders), so 2e-5 absolute and relative; the
kernels' plain versions stack a whole block (LN, products of 96-768 terms,
softmax, MLP), so 2e-4. The CUDA kernels themselves run only on a card:
tests/test_torch_port_cuda.py holds them against their plain versions.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_video_tpu.models import hiera as jhiera
from sam2_video_tpu.models import memory_encoder as jme
from sam2_video_tpu.ops import attention as jattn
from sam2_video_tpu.ops import common as jnn
from sam2_video_tpu.ops import hiera_block_kernel as jhbk
from sam2_video_tpu.ops import position_encoding as jpe
from sam2_video_tpu.ops import resize as jrs
from sam2_video_tpu.ops.memory_encoder_kernel import \
    fused_memory_encoder as jfused_memory_encoder
from sam2_video_tpu_torch.convert import from_jax_params, to_param_tree
from sam2_video_tpu_torch.models import memory_encoder as tme
from sam2_video_tpu_torch.ops import attention as tattn
from sam2_video_tpu_torch.ops import common as tnn
from sam2_video_tpu_torch.ops import hiera_block_kernel as thbk
from sam2_video_tpu_torch.ops import kernel_build
from sam2_video_tpu_torch.ops import memory_encoder_kernel as tmek
from sam2_video_tpu_torch.ops import position_encoding as tpe
from sam2_video_tpu_torch.ops import resize as trs
from test_torch_port_models import jax_tree, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
OP_TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               **tol)


def _hwio(w):
    """numpy OIHW -> HWIO (the JAX conv layout)."""
    return np.transpose(w, (2, 3, 1, 0))


@pytest.fixture
def g():
    return np.random.default_rng(11)


def test_linear_matches_jax(g):
    w, b = g.standard_normal((24, 40)) / np.sqrt(40), g.standard_normal(24)
    x = g.standard_normal((3, 5, 40))
    want = jnn.linear({"weight": jnp.asarray(w, jnp.float32),
                       "bias": jnp.asarray(b, jnp.float32)},
                      jnp.asarray(x, jnp.float32))
    _close(tnn.linear({"weight": _t(w), "bias": _t(b)}, _t(x)), want, OP_TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_jax(g, eps):
    p = {"weight": g.standard_normal(48), "bias": g.standard_normal(48)}
    x = 3.0 * g.standard_normal((4, 6, 48)) + 1.0
    want = jnn.layer_norm({k: jnp.asarray(v, jnp.float32)
                           for k, v in p.items()},
                          jnp.asarray(x, jnp.float32), eps=eps)
    got = tnn.layer_norm({k: _t(v) for k, v in p.items()}, _t(x), eps=eps)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("stride,padding,groups,k,cin,cout", [
    (4, 3, 1, 7, 3, 16),      # Hiera patch embed
    (2, 1, 1, 3, 4, 16),      # mask downsampler layer
    (1, 3, 8, 7, 8, 8),       # CXBlock depthwise
    (1, 0, 1, 1, 32, 8),      # 1x1 projection
])
def test_conv2d_matches_jax(g, stride, padding, groups, k, cin, cout):
    w = g.standard_normal((cout, cin // groups, k, k)) * 0.2
    b = g.standard_normal(cout)
    x = g.standard_normal((2, 16, 16, cin))
    want = jnn.conv2d({"weight": jnp.asarray(_hwio(w), jnp.float32),
                       "bias": jnp.asarray(b, jnp.float32)},
                      jnp.asarray(x, jnp.float32), stride=stride,
                      padding=padding, groups=groups)
    got = tnn.conv2d({"weight": _t(w), "bias": _t(b)}, _t(x), stride=stride,
                     padding=padding, groups=groups)
    _close(got, want, OP_TOL)


def test_conv_transpose2d_matches_jax(g):
    w = g.standard_normal((16, 8, 2, 2))     # torch IOHW
    b = g.standard_normal(8)
    x = g.standard_normal((2, 5, 6, 16))
    want = jnn.conv_transpose2d(
        {"weight": jnp.asarray(np.transpose(w, (2, 3, 0, 1)), jnp.float32),
         "bias": jnp.asarray(b, jnp.float32)},
        jnp.asarray(x, jnp.float32), stride=2)
    got = tnn.conv_transpose2d({"weight": _t(w), "bias": _t(b)}, _t(x), 2)
    _close(got, want, OP_TOL)


def test_max_pool2d_and_gelu_match_jax(g):
    x = g.standard_normal((2, 9, 8, 5))
    _close(tnn.max_pool2d(_t(x), 2, 2),
           jnn.max_pool2d(jnp.asarray(x, jnp.float32), 2, 2), OP_TOL)
    _close(tnn.gelu(_t(x)), jnn.gelu(jnp.asarray(x, jnp.float32)), OP_TOL)


@pytest.mark.parametrize("activation,sigmoid", [("relu", False),
                                                ("gelu", False),
                                                ("relu", True)])
def test_mlp_matches_jax(g, activation, sigmoid):
    dims = [16, 32, 32, 4]
    layers = {str(i): {"weight": g.standard_normal((dims[i + 1], dims[i]))
                       / np.sqrt(dims[i]),
                       "bias": g.standard_normal(dims[i + 1])}
              for i in range(3)}
    x = g.standard_normal((5, 16))
    jp = {"layers": {k: {n: jnp.asarray(a, jnp.float32) for n, a in v.items()}
                     for k, v in layers.items()}}
    tp = {"layers": {k: {n: _t(a) for n, a in v.items()}
                     for k, v in layers.items()}}
    if activation == "gelu":
        # the JAX mlp's "gelu" is jax.nn.gelu's default tanh approximation;
        # the port (like the torch reference and the TPU kernels) uses the
        # exact erf, so hold it against the exact form
        h = jnp.asarray(x, jnp.float32)
        for i in range(3):
            h = jnn.linear(jp["layers"][str(i)], h)
            h = jnn.gelu(h) if i < 2 else h
        want = h
    else:
        want = jnn.mlp(jp, jnp.asarray(x, jnp.float32), activation, sigmoid)
    _close(tnn.mlp(tp, _t(x), activation, sigmoid), want, OP_TOL)


def test_sine_pe_matches_jax():
    _close(tpe.sine_pe_2d(6, 9, 64), jpe.sine_pe_2d(6, 9, 64), OP_TOL)
    pos = np.asarray([0.0, 0.25, 0.5, 1.0, -0.5], np.float32)
    _close(tpe.sine_pe_1d(_t(pos), 256),
           jpe.sine_pe_1d(jnp.asarray(pos), 256), OP_TOL)


def test_random_pe_matches_jax(g):
    gm = g.standard_normal((2, 64))
    jp = {"positional_encoding_gaussian_matrix": jnp.asarray(gm, jnp.float32)}
    tp = {"positional_encoding_gaussian_matrix": _t(gm)}
    _close(tpe.random_pe_grid(tp, 8, 8), jpe.random_pe_grid(jp, 8, 8),
           dict(atol=1e-4, rtol=1e-4))
    coords = g.uniform(0, 128, (3, 4, 2))
    _close(tpe.random_pe_coords(tp, _t(coords), (128, 128)),
           jpe.random_pe_coords(jp, jnp.asarray(coords, jnp.float32),
                                (128, 128)),
           dict(atol=1e-4, rtol=1e-4))


def test_rope_half_matches_jax(g):
    cos_t, sin_t = tpe.axial_rope_table_half(64, 6, 4)
    cos_j, sin_j = jpe.axial_rope_table_half(64, 6, 4)
    _close(cos_t, cos_j, OP_TOL)
    _close(sin_t, sin_j, OP_TOL)
    np.testing.assert_array_equal(tpe.deinterleave_perm(64, 2),
                                  jpe.deinterleave_perm(64, 2))
    x = g.standard_normal((2, 24, 64))
    _close(tpe.apply_rope_half(_t(x), cos_t, sin_t),
           jpe.apply_rope_half(jnp.asarray(x, jnp.float32), cos_j, sin_j),
           OP_TOL)


@pytest.mark.parametrize("kind,out_hw", [("bilinear", (8, 12)),
                                         ("bilinear", (40, 52)),
                                         ("nearest", (32, 32)),
                                         ("bicubic", (24, 20))])
def test_resize_matches_jax(g, kind, out_hw):
    """Bilinear shrinking antialiases in both (JAX 'linear' == torch
    antialias=True), growing is plain bilinear; 1e-4 covers the two
    filters' float32 weight arithmetic."""
    if kind == "bicubic":
        x = g.standard_normal((1, 7, 7, 6))
        want = jrs.resize_bicubic_torch(jnp.asarray(x, jnp.float32), out_hw)
        got = trs.resize_bicubic_torch(_t(x), out_hw)
    else:
        x = g.standard_normal((2, 3, 16, 16))
        fn = {"bilinear": (jrs.resize_bilinear, trs.resize_bilinear),
              "nearest": (jrs.resize_nearest, trs.resize_nearest)}[kind]
        want = fn[0](jnp.asarray(x, jnp.float32), out_hw)
        got = fn[1](_t(x), out_hw)
    _close(got, want, dict(atol=1e-4, rtol=1e-4))


def test_sdpa_and_heads_match_jax(g):
    q = g.standard_normal((2, 4, 10, 16))
    k = g.standard_normal((2, 4, 13, 16))
    v = g.standard_normal((2, 4, 13, 8))
    bias = np.where(g.uniform(size=13) < 0.3, -1e9, 0.0)
    want = jattn.sdpa(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                      jnp.asarray(bias, jnp.float32))
    _close(tattn.sdpa(_t(q), _t(k), _t(v), _t(bias)), want, OP_TOL)
    x = g.standard_normal((2, 7, 32))
    _close(tattn.merge_heads(tattn.split_heads(_t(x), 4)), x, OP_TOL)
    _close(tattn.split_heads(_t(x), 4),
           jattn.split_heads(jnp.asarray(x, jnp.float32), 4), OP_TOL)


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

TRUNK = jhiera.HIERA_PRESETS["tiny"]


@pytest.fixture(scope="module")
def trunk_params():
    p = jax_tree(dict(image_size=128), seed=0)["image_encoder"]["trunk"]
    return p, to_param_tree(p)


def test_fused_block_plain_matches_jax_kernel(trunk_params):
    """Block 4 of the 384-px tiny trunk: 14x14 windows on a 24x24 grid, so
    the pad tokens enter attention as keys. The port's wrapper on a CPU
    tensor is the plain block; it must equal the JAX block and the Pallas
    kernel run in interpret mode."""
    jp, tp = trunk_params
    i, H = 4, 24
    spec = TRUNK.block_specs()[i]
    x = np.random.default_rng(4).standard_normal((1, H, H, spec["dim"]))
    xj = jnp.asarray(x, jnp.float32)
    want_kernel, want_plain = jax.jit(lambda b, v: (
        jhbk.fused_block(b, v, spec, TRUNK.q_stride, TRUNK.mlp_ratio,
                         interpret=True),
        jhiera._block(b, v, spec, TRUNK.q_stride)))(jp["blocks"][str(i)], xj)
    before = thbk.fused_block.launches
    got = thbk.fused_block(tp["blocks"][str(i)], _t(x), spec, TRUNK.q_stride,
                           TRUNK.mlp_ratio)
    assert thbk.fused_block.launches == before
    _close(got, want_plain, BLOCK_TOL)
    _close(got, want_kernel, BLOCK_TOL)


def test_fused_memory_encoder_plain_matches_jax_kernel():
    """One object at 128 px (8x8 features, the smallest geometry the TPU
    kernel takes); params perturbed off their constant initialisation. The
    JAX plain path is held against the port's in the models test."""
    cfg = jme.MemoryEncoderConfig()
    p = jax_tree(dict(image_size=128), seed=3)["memory_encoder"]
    leaves, treedef = jax.tree.flatten(p)
    rng = np.random.default_rng(7)
    p = jax.tree.unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])
    N, S = 1, 128
    pix = rng.standard_normal((N, S // 16, S // 16, 256)).astype(np.float32)
    masks = (20.0 / (1.0 + np.exp(-rng.standard_normal((N, S, S, 1))))
             - 10.0).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, p)
    want = jax.jit(lambda q, x, m: jfused_memory_encoder(
        q, cfg, jnn.conv2d(q["pix_feat_proj"], x), m))(
        pj, jnp.asarray(pix), jnp.asarray(masks))

    tp = to_param_tree(p)
    tcfg = tme.MemoryEncoderConfig()
    pix_proj = tnn.conv2d(tp["pix_feat_proj"], _t(pix))
    before = tmek.fused_memory_encoder.launches
    got = tmek.fused_memory_encoder(tp, tcfg, pix_proj, _t(masks))
    assert tmek.fused_memory_encoder.launches == before
    _close(got, want, BLOCK_TOL)
    naive = tme._mask_downsampler_naive(tp["mask_downsampler"], tcfg,
                                        _t(masks))
    s2d = tme._mask_downsampler_s2d(tp["mask_downsampler"], tcfg, _t(masks))
    _close(s2d, naive.numpy(), BLOCK_TOL)


def test_from_jax_params_round_trips_through_the_jax_converter():
    """The port's seeded init, converted to a JAX tree by the JAX package's
    own converter (training/convert.py, strict: every name and layout must
    match a sam2.init template), comes back bit for bit through
    from_jax_params."""
    from sam2_video_tpu_torch.models import sam2 as tsam2

    sd = tsam2.init(tsam2.SAM2Config(image_size=128), seed=5).state_dict()
    tree = jax_tree(dict(image_size=128), seed=5)
    back = from_jax_params(tree)
    assert set(back) == set(sd)
    for name, want in sd.items():
        torch.testing.assert_close(back[name], want, rtol=0, atol=0,
                                   msg=name)


# ---------------------------------------------------------------------------
# Package rules: no JAX, no silent fallback
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = REPO / "sam2_video_tpu_torch"
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "sam2_video_tpu"), \
                    f"{path.relative_to(REPO)} imports {n}"
    code = ("import sys, json, sam2_video_tpu_torch, "
            "sam2_video_tpu_torch.eval.predictor, "
            "sam2_video_tpu_torch.ops.hiera_block_kernel, "
            "sam2_video_tpu_torch.ops.memory_encoder_kernel, "
            "sam2_video_tpu_torch.ops.flash_attention, "
            "sam2_video_tpu_torch.ops.memattn_layer_kernel, "
            "sam2_video_tpu_torch.training.loop, "
            "sam2_video_tpu_torch.profile_train; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'sam2_video_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernel_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.build(force=True)


def test_wrappers_refuse_unsupported_cuda_input():
    """Shape and dtype checks run before any build or launch."""
    spec = TRUNK.block_specs()[0]
    with pytest.raises(TypeError, match="bfloat16"):
        thbk._check(torch.zeros((1, 8, 8, 96)), spec, (2, 2), 384)
    bad = dict(spec, num_heads=96 // 4)          # head dim 4
    with pytest.raises(ValueError, match="head dim"):
        thbk._check(torch.zeros((1, 8, 8, 96), dtype=torch.bfloat16), bad,
                    (2, 2), 384)
