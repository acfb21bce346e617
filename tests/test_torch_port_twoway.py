"""Kernel #8, the two-way decoder block, in the PyTorch port held against
the JAX package on the CPU, in float32.

- The block: ``twoway_block_plain`` (what ``fused_twoway_block`` runs on a
  CPU tensor) against JAX ``twoway_kernel.fused_twoway_block`` in
  interpret mode, values and the VJP of every weight, queries, keys, qpe
  and kpe, at two geometries, first block and later block.
- The decoder with ``fused_twoway=True`` against JAX ``mask_decoder.apply``
  with ``MaskDecoderConfig(fused_twoway=True)`` (interpreted kernel).
- The slice as a whole: one all-trainable train step with
  ``SAM2Config(fused_twoway=True)`` against JAX ``make_train_step`` (its
  XLA decoder path, which ``tests/test_twoway_fused.py`` pins to the
  kernel).
- The card's geometry check: what the CUDA kernel refuses.

The JAX tree is the port's seeded init through the JAX package's strict
converter (``jax_tree``); the block tests move every leaf of the block off
its initial constants with numpy noise, so the LayerNorm weights are not
ones. Tolerances: block values 5e-5 and gradients 3e-4 of max(1, max|JAX|)
of each tensor (``tests/test_twoway_fused.py``'s gradient tolerance;
float32 sums of up to 2048 products in another order); the decoder 5e-4
(``tests/test_torch_port_models.py``'s DEEP_TOL); the train step as
``tests/test_torch_port_train_all.py`` states it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _example_clip
from sam2_video_tpu.models import mask_decoder as jmd
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.ops import twoway_kernel as jtwk
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.data.synthetic import example_clip
from sam2_video_tpu_torch.models import mask_decoder as tmd
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.ops import twoway_kernel as twk
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_models import exact_gelu, jax_tree  # noqa: F401
from test_torch_port_train import FAST_COMPILE
from test_torch_port_train_all import (FROZEN, GRAD, LR, TRAINABLE, VAL,
                                       _close)

IMG = 128
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=True,
          use_activation_checkpoint=False)
BLOCK_VAL, BLOCK_GRAD, DECODER = 5e-5, 3e-4, 5e-4
HEADS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """The JAX kernel in interpret mode, as its own tests run it."""
    monkeypatch.setattr(jtwk, "INTERPRET", True)


@pytest.fixture(scope="module")
def jp():
    return jax_tree(KW, seed=4)


def _block(jp, first: bool):
    """The decoder's first or second block, every leaf + 0.05 N(0, 1):
    (numpy tree for JAX, torch tree for the port)."""
    rng = np.random.default_rng(11 + first)
    tree = jp["sam_mask_decoder"]["transformer"]["layers"]["0" if first
                                                          else "1"]
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32)
                       + 0.05 * rng.standard_normal(a.shape).astype(
                           np.float32), tree)
    return npt, jax.tree.map(torch.from_numpy, npt)


def _inputs(O, N, HW, seed):
    rng = np.random.default_rng(seed)
    C = 256
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((O, N, C), (O, HW, C), (O, N, C), (HW, C))]


def _jax_block(p, first):
    def run(queries, keys, qpe, kpe):
        q, k = jtwk.fused_twoway_block(p, queries[None], keys[None],
                                       qpe[None], kpe, first, heads=HEADS,
                                       interpret=True)
        return q[0], k[0]
    return run


GEOMETRIES = [(4, 8, 64), (2, 9, 48)]


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("O,N,HW", GEOMETRIES)
def test_block_values_match_jax(jp, first, O, N, HW):
    npt, tp = _block(jp, first)
    x = _inputs(O, N, HW, seed=O * 100 + HW)
    want = jax.jit(_jax_block(npt, first))(*x)
    got = twk.twoway_block_plain(tp, *(torch.from_numpy(a) for a in x),
                                 first, HEADS)
    for name, a, b in zip(("queries", "keys"), got, want, strict=True):
        _close(a, b, BLOCK_VAL, name)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("O,N,HW", GEOMETRIES)
def test_block_grads_match_jax(jp, first, O, N, HW):
    """The port's autograd through the plain block against ``jax.vjp`` of
    the interpreted kernel (its B1 and B2 programs), one random cotangent
    for each output."""
    npt, tp = _block(jp, first)
    x = _inputs(O, N, HW, seed=O * 100 + HW + 1)
    rng = np.random.default_rng(O + HW)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((O, N, 256), (O, HW, 256))]

    def jvjp(p, *inputs):
        _, vjp = jax.vjp(lambda p, *a: _jax_block(p, first)(*a), p, *inputs)
        return vjp(tuple(cots))

    jgrads = jax.jit(jvjp)(npt, *x)
    w = [t.clone().requires_grad_(True) for t in twk.leaves(tp)]
    xs = [torch.from_numpy(a).requires_grad_(True) for a in x]
    outs = twk.twoway_block_plain(twk.block_params(w), *xs, first, HEADS)
    tgrads = torch.autograd.grad(outs, w + xs,
                                 [torch.from_numpy(c) for c in cots])
    jw = [twk._leaf(jgrads[0], path) for path in twk.LEAVES]
    names = [".".join(p) for p in twk.LEAVES] + ["queries", "keys", "qpe",
                                                  "kpe"]
    for name, a, b in zip(names, tgrads, jw + list(jgrads[1:]),
                          strict=True):
        _close(a, b, BLOCK_GRAD, name)


@pytest.mark.parametrize("multimask", [False, True])
def test_fused_decoder_matches_jax(jp, multimask):
    """The port's decoder with fused_twoway=True (qpe the original tokens
    in both blocks, the image pe in the keys' dtype, the final attention
    plain) against the JAX decoder on its fused path."""
    jcfg = dataclasses.replace(jsam2.SAM2Config(**KW).mask_decoder_config,
                               fused_twoway=True)
    tcfg = tsam2.SAM2Config(**KW, fused_twoway=True).mask_decoder_config
    assert tcfg.fused_twoway
    g = np.random.default_rng(5)
    F, C, B = IMG // 16, 256, 3
    emb = g.standard_normal((B, F, F, C))
    pe = g.standard_normal((F, F, C))
    sparse = g.standard_normal((B, 2, C))
    dense = g.standard_normal((B, F, F, C))
    hr = (g.standard_normal((B, 4 * F, 4 * F, C // 8)),
          g.standard_normal((B, 2 * F, 2 * F, C // 4)))
    want = jax.jit(lambda p, *a: jmd.apply(
        p, jcfg, *a[:4], multimask_output=multimask,
        high_res_features=a[4:], training=False))(
        jp["sam_mask_decoder"],
        *(jnp.asarray(a, jnp.float32) for a in (emb, pe, sparse, dense, *hr)))
    tp = to_param_tree(jp)
    got = tmd.apply(tp["sam_mask_decoder"], tcfg,
                    *(torch.tensor(a, dtype=torch.float32)
                      for a in (emb, pe, sparse, dense)),
                    multimask_output=multimask,
                    high_res_features=tuple(
                        torch.tensor(a, dtype=torch.float32) for a in hr),
                    training=False)
    for a, b in zip(got, want, strict=True):
        _close(a, b, DECODER)


def test_fused_switch_reaches_the_decoder_and_its_operands():
    """SAM2Config.fused_twoway is forwarded to the decoder's config, and
    ``prepare`` packs each decoder block's kernel operands once."""
    cfg = tsam2.SAM2Config(**KW, fused_twoway=True)
    assert cfg.mask_decoder_config.fused_twoway
    assert not tsam2.SAM2Config(**KW).mask_decoder_config.fused_twoway
    tree = tsam2.prepare(tsam2.init(cfg, seed=0), cfg)
    layers = tree["sam_mask_decoder"]["transformer"]["layers"]
    for i in ("0", "1"):
        layer = layers[i]
        ops = layer["_ops"]
        assert len(ops) == 30
        assert ops[0].dtype == torch.bfloat16
        assert tuple(ops[0].shape) == (768, 256)
        assert torch.equal(ops[8][:128], layer["cross_attn_token_to_image"][
            "k_proj"]["weight"].to(torch.bfloat16))


def test_fused_train_step_matches_jax(exact_gelu, monkeypatch):  # noqa: F811
    """One all-trainable step with fused_twoway=True (the port's decoder
    through ``fused_twoway_block``, on these CPU tensors its plain block)
    against JAX ``make_train_step`` on its XLA decoder path: losses and
    every trainable leaf's gradient (``optax.global_norm`` patched to the
    identity, so the JAX step returns its gradients). The JAX step with its
    interpreted kernel in the decoder took ~170 s here, ~110 s more than
    this; ``tests/test_twoway_fused.py`` pins the XLA path to the kernel
    within 3e-5, and the block tests above pin the port's block to the
    interpreted kernel itself."""
    T, O = 2, 2
    jp = jax_tree(KW, seed=9)
    jcfg = jsam2.SAM2Config(**KW)
    tx = jopt.make_optimizer(jp, {"lr": LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=TRAINABLE)
    monkeypatch.setattr(optax, "global_norm", lambda g: g)
    jstep = jloop.make_train_step(JVideoModelConfig(sam2=jcfg), JLossConfig(),
                                  tx, trainable_modules=TRAINABLE)
    args = (jloop.TrainState.create(jp, tx),
            _example_clip(IMG, T=T, O=O, C=2, B=2))
    _, jm = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    jgrads = dict(to_param_tree(jax.tree.map(np.asarray, jm["grad_norm"]))
                  .named_parameters())

    tcfg = tsam2.SAM2Config(**KW, fused_twoway=True)
    params = to_param_tree(jax.tree.map(np.array, jp))
    ttx = topt.make_optimizer(params, {"lr": LR, "type": "AdamW"},
                              {"enabled": False}, total_steps=1000,
                              trainable_modules=TRAINABLE)
    tstep = tloop.make_train_step(VideoModelConfig(sam2=tcfg), LossConfig(),
                                  ttx, trainable_modules=TRAINABLE,
                                  device="cpu")
    calls = []
    block = twk.fused_twoway_block

    def counted(*a, **k):
        calls.append(k["first"])
        return block(*a, **k)

    monkeypatch.setattr(twk, "fused_twoway_block", counted)
    _, metrics, grads = tstep.with_grads(
        tloop.TrainState.create(params, ttx),
        example_clip(IMG, T=T, O=O, C=2, B=2))
    # both blocks of every decoder call (B clips x T frames) took the route
    assert calls == [True, False] * (2 * T)
    for k in ("total_loss", "loss_mask", "loss_dice", "loss_iou"):
        _close(metrics[k], jm[k], VAL, k)
    assert set(grads) == {n for n, _ in params.named_parameters()
                          if n.split(".")[0] not in FROZEN}
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD, name,
               pool_flips=name.startswith("image_encoder."))
    blocks = [n for n in grads
              if n.startswith("sam_mask_decoder.transformer.layers.")]
    assert len(blocks) == 2 * 36 and all(grads[n].any() for n in blocks)


def _bad_geometry(jp, case):
    _, tp = _block(jp, False)
    x = [torch.from_numpy(a) for a in _inputs(2, 8, 16, seed=0)]
    heads = HEADS
    if case == "float32":
        return tp, x, heads, TypeError
    if case == "heads":
        heads = 4
    elif case == "mlp":
        mlp = tp["mlp"]["layers"]
        mlp["0"] = {"weight": mlp["0"]["weight"][:1024],
                    "bias": mlp["0"]["bias"][:1024]}
        mlp["1"] = {"weight": mlp["1"]["weight"][:, :1024],
                    "bias": mlp["1"]["bias"]}
    elif case == "kpe":
        x[3] = x[3][:8]
    elif case == "qpe":
        x[2] = x[2][:, :4]
    return tp, [t.to(torch.bfloat16) for t in x], heads, NotImplementedError


@pytest.mark.parametrize("case", ["float32", "heads", "mlp", "kpe", "qpe"])
def test_kernel_geometry_check_refuses(jp, case):
    """What a CUDA tensor meets before the kernel: a geometry other than
    the SAM2 decoder's raises NotImplementedError naming it (the JAX
    package would take its XLA block; the port does not fall back), a
    dtype other than bf16 a TypeError. The plain block takes each of these
    geometries on the CPU."""
    tp, x, heads, err = _bad_geometry(jp, case)
    with pytest.raises(err, match="fused_twoway_block kernel takes"):
        twk.check_geometry(tp, *x, heads)
    if case not in ("kpe", "qpe"):
        twk.fused_twoway_block(tp, *(t.float() for t in x), False, heads)
