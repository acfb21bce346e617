"""The trainable Hiera block of the PyTorch port (``ops/hiera_block_bwd.py``
``fused_block_trainable``, kernel #6's module) held against the JAX
package on the CPU, in float32: SAM2-tiny's trunk at image_size=128, one
JAX parameter tree (``jax_tree``) carried over with ``from_jax_params``,
inputs and cotangents from a numpy seed.

On a CPU tensor ``fused_block_trainable`` is its plain version, autograd
through ``models/hiera.py`` ``_block``. Per geometry class of the tiny
trunk (``tests/test_hiera_fused.py`` ``_block_geometries`` at 128 px), its
value and its gradients with respect to every parameter and to x are
compared with

- ``jax.vjp`` of the JAX ``models/hiera.py`` ``_block`` under
  ``exact_gelu`` (the JAX Hiera MLP's default GELU is the tanh
  approximation; the port, the torch reference and the kernels use erf),
  for every class;
- the JAX kernel itself, ``hiera_block_bwd.fused_block_trainable`` in
  Pallas interpret mode, for the six classes it takes (the JAX package
  sends the two stage-4 classes to XLA for want of VMEM).

Tolerance: 2e-3 absolute (of max(1, max|JAX|) of each tensor) and 2e-3
relative, ``tests/test_hiera_fused.py``'s limit for the Pallas backward
against XLA: float32 sums of up to 3072 products in other orders, and the
Pallas kernel's own walk (it rounds q, k, v and the probabilities to the
input dtype, which is float32 here, but sums its accumulators in band
order).

On q-pool classes the two forward passes may order a near-tied 2x2 cell
differently (float32 sums in other orders), and the cell's gradient then
goes to another element: one such flip moves one gradient contribution
between rows of a weight gradient. There, as in
``tests/test_hiera_fused.py`` ``_assert_grads_close(allow_pool_flips=
True)``, a tensor may have at most 1% of its elements outside the limit
and must lie within 2e-2 relative L2 (Frobenius) of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_video_tpu.models import hiera as jhiera
from sam2_video_tpu.ops import hiera_block_bwd as jhbb
from sam2_video_tpu_torch.convert import flatten, from_jax_params, unflatten
from sam2_video_tpu_torch.models import hiera as thiera
from sam2_video_tpu_torch.ops import hiera_block_bwd as thbb
from sam2_video_tpu_torch.ops import hiera_block_kernel as thbk
from test_torch_port_models import exact_gelu, jax_tree  # noqa: F401

IMG = 128
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=False,
          use_activation_checkpoint=False)
TOL = 2e-3
TRUNK = jhiera.HIERA_PRESETS["tiny"]
CLASSES = {0: "plain ws8", 1: "pooled ws8", 2: "plain ws4", 3: "pooled ws4",
           4: "padded ws14", 5: "global", 10: "stage-4 pooled",
           11: "stage-4 plain"}
JAX_KERNEL = (0, 1, 2, 3, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trunk():
    """The trunk's JAX parameters (a seeded port init through the JAX
    strict converter)."""
    return jax_tree(KW, seed=11)["image_encoder"]["trunk"]


def _geometry(i):
    """(spec, grid) of block i along the 128-px trunk
    (``test_hiera_fused._block_geometries(128)``)."""
    H = IMG // 4
    for j, spec in enumerate(TRUNK.block_specs()):
        if j == i:
            return spec, H
        if spec["q_pool"]:
            H //= 2
    raise IndexError(i)


def _torch_leaves(jtree):
    """name -> float32 torch leaf that requires grad (torch layout)."""
    return {n: t.requires_grad_(True)
            for n, t in from_jax_params(jtree).items()}


FLIP_FRACTION, FLIP_REL_L2 = 0.01, 2e-2


def _close(got, want, name, pool_flips=False):
    a = got.detach().double().numpy()
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    if not pool_flips:
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=TOL,
                                   err_msg=name)
        return
    bad = ~np.isclose(a, b, atol=TOL * scale, rtol=TOL)
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    assert bad.mean() <= FLIP_FRACTION and rel <= FLIP_REL_L2, (
        name, int(bad.sum()), rel)


def _jax_vjp(fn, p, x, cot):
    def run(pp, xx, cc):
        out, pull = jax.vjp(fn, pp, xx)
        return out, pull(cc)
    return jax.jit(run)(p, x, cot)


@pytest.mark.parametrize("i", list(CLASSES),
                         ids=[f"{i}-{c.replace(' ', '_')}"
                              for i, c in CLASSES.items()])
def test_trainable_block_matches_jax(trunk, exact_gelu, i):  # noqa: F811
    spec, H = _geometry(i)
    g = np.random.default_rng(100 + i)
    x = g.standard_normal((2, H, H, spec["dim"])).astype(np.float32)
    bj = trunk["blocks"][str(i)]
    y_shape = jax.eval_shape(
        lambda v: jhiera._block(bj, v, spec, TRUNK.q_stride),
        jnp.asarray(x)).shape
    cot = g.standard_normal(y_shape).astype(np.float32)

    leaves = _torch_leaves(bj)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = thbb.fused_block_trainable(unflatten(leaves), xt, spec,
                                     TRUNK.q_stride, TRUNK.mlp_ratio)
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()),
                                torch.from_numpy(cot))

    refs = [("XLA _block", lambda p, v: jhiera._block(p, v, spec,
                                                      TRUNK.q_stride))]
    if i in JAX_KERNEL:
        assert jhbb.fused_block_bwd_eligible(spec, H, H, TRUNK.mlp_ratio,
                                             interpret=True)
        refs.append(("Pallas kernel", lambda p, v: jhbb.fused_block_trainable(
            p, v, spec, TRUNK.q_stride, TRUNK.mlp_ratio, interpret=True)))
    for label, fn in refs:
        jout, (jgp, jgx) = _jax_vjp(fn, bj, jnp.asarray(x), jnp.asarray(cot))
        flips = spec["q_pool"]
        _close(out, jout, f"{label}: value")
        _close(grads[0], jgx, f"{label}: dx", flips)
        want = from_jax_params(jax.tree.map(np.asarray, jgp))
        assert set(want) == set(leaves)
        for name, gr in zip(leaves, grads[1:], strict=True):
            _close(gr, want[name].numpy(), f"{label}: d{name}", flips)


def test_kernel_operands_follow_the_leaves(trunk):
    """The trainable block's leaves (``leaves``) are in the order of the
    operands of the forward-only block's ``pack``, which its kernels read
    and in whose order its backward splits the gradients: operand k is
    leaf k in the operand's dtype. ``block_params`` inverts ``leaves``."""
    for i, spec in enumerate(TRUNK.block_specs()):
        p = unflatten(from_jax_params(trunk["blocks"][str(i)]))
        w = thbb.leaves(p, spec)
        ops = thbk.pack(p, spec)
        assert len(ops) == 14
        assert len(w) == (14 if spec["dim"] != spec["dim_out"] else 12)
        for k, o in enumerate(ops):
            if k >= len(w):
                assert o is None
                continue
            assert torch.equal(o, w[k].to(o.dtype))
        back = thbb.leaves(thbb.block_params(w, spec), spec)
        assert all(a is b for a, b in zip(back, w, strict=True))


def test_trunk_gradients_through_the_trainable_blocks(
        trunk, exact_gelu):  # noqa: F811
    """``hiera.apply(fused_vjp=True)``: the whole trunk (patch embed,
    pos-embed through the bicubic resize, 12 blocks) with every block on
    the trainable path. Its gradients (a numpy cotangent per stage) equal
    those of the forward-only routing on the CPU, where both run the plain
    blocks, and JAX's ``jax.vjp`` of the plain trunk."""
    g = np.random.default_rng(7)
    x = g.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    shapes = [o.shape for o in jax.eval_shape(
        lambda v: jhiera.apply(trunk, v, TRUNK), jnp.asarray(x))]
    cots = [g.standard_normal(s).astype(np.float32) for s in shapes]

    res = {}
    for vjp in (True, False):
        leaves = _torch_leaves(trunk)
        xt = torch.from_numpy(x).requires_grad_(True)
        outs = thiera.apply(unflatten(leaves), xt, TRUNK, fused_vjp=vjp)
        res[vjp] = (outs, torch.autograd.grad(
            outs, [xt] + list(leaves.values()),
            [torch.from_numpy(c) for c in cots]), list(leaves))
    (outs, grads, names), (_, plain_grads, _) = res[True], res[False]
    for a, b in zip(grads, plain_grads, strict=True):
        assert torch.equal(a, b)

    jouts, (jgp, jgx) = _jax_vjp(lambda p, v: jhiera.apply(p, v, TRUNK),
                                 trunk, jnp.asarray(x),
                                 [jnp.asarray(c) for c in cots])
    for k, (a, b) in enumerate(zip(outs, jouts, strict=True)):
        _close(a, b, f"stage {k}")
    # three q-pool blocks: near-tied cells may route apart (see the header)
    _close(grads[0], jgx, "dx", True)
    want = from_jax_params(jax.tree.map(np.asarray, jgp))
    assert set(want) == set(names) == set(flatten(trunk))
    for name, gr in zip(names, grads[1:], strict=True):
        _close(gr, want[name].numpy(), f"d{name}", True)


@pytest.mark.parametrize("H, W", [(4, 6), (8, 8)])
def test_walk_pool_rule_matches_jax(H, W):
    """The 2x2 max-pool backward of ``fused_block_trainable_walk`` (the
    card checks' yardstick for kernel #6's routed gradients) against JAX's
    ``_unpool2x2_rows_cols``, the rule kernel #6 follows, on values drawn
    from {0, 1, 2} so that most 2x2 cells hold ties: the same element
    takes each cell's gradient."""
    rng = np.random.default_rng(H * W)
    vals = rng.integers(0, 3, (3, H, W, 5)).astype(np.float32)
    d = rng.standard_normal((3, H // 2, W // 2, 5)).astype(np.float32)
    x = torch.from_numpy(vals).requires_grad_(True)
    out = thbb._MaxPoolJaxRule.apply(x, 2, 2)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(d))
    want = np.stack([np.asarray(jhbb._unpool2x2_rows_cols(
        jnp.asarray(v), jnp.asarray(g))) for v, g in zip(vals, d)])
    np.testing.assert_array_equal(got.numpy(), want)
