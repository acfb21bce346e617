"""The generic flash attention (kernel #7) of the PyTorch port and the
memory attention that reaches it held against the JAX package on the CPU,
in float32:

- (a) ``flash_attention_plain`` and its autograd against the JAX Pallas
  kernel ``_flash_attention_3d`` run in interpret mode, its keys padded to
  a multiple of 256 with a -1e9 bias as the JAX wrapper pads them (and, for
  a value width of 64, v padded to 128 lanes and the output sliced, as the
  JAX memory attention does): out, dq, dk and dv for one numpy cotangent,
  at head width 128 / value width 128 (two heads of d_model 256) and 256 /
  64, over a ragged key count whose bias masks a whole slot;
- (b) memory attention with ``use_flash=True`` on CPU tensors against JAX
  ``memory_attention.apply``: two heads (the cross-attention takes
  ``flash_attention`` on split heads with a projected v) and one head over
  128-channel memory (``flash_attention`` with the raw memory as v, the
  commute): values and the gradients of every parameter, the queries, the
  memory and its positional encoding for one numpy cotangent;
- (c) one whole memory-only train step with two memory-attention heads,
  SAM2-tiny at 128 px, T=3, O=2, C=2, B=2, against JAX
  ``make_train_step``, whose ``SAM2Config`` reaches two heads through a
  subclass local to this file (it does not forward the setting); the
  checks and tolerances of ``tests/test_torch_port_train.py``.

Tolerances, each of max(1, max|JAX|) of the tensor: (a) 3e-5 for values
and 2e-4 for gradients (the JAX kernel tests' atol; float32 sums of up to
~1300 products in another order); (b) and (c) 1e-4 for values and 2e-4 for
gradients (the same sums through 2 or 4 layers), Adam's updates as in
``tests/test_torch_port_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _example_clip
from sam2_video_tpu.models import memory_attention as jma
from sam2_video_tpu.models import sam2 as jsam2
from sam2_video_tpu.models.video_model import \
    VideoModelConfig as JVideoModelConfig
from sam2_video_tpu.ops import flash_attention as jfa
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.data.synthetic import example_clip
from sam2_video_tpu_torch.models import memory_attention as tma
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.ops import flash_attention as tfa
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_models import jax_tree
from test_torch_port_train import (EPS, FAST_COMPILE, GRAD, IMG, KW, LR,
                                   T_STEP, TRAINABLE, VAL, _close, _leaves,
                                   _nest)

KERNEL_VAL = 3e-5
HEADS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the kernel's plain version against the interpreted Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D, Dv, BH", [(128, 128, 4), (256, 64, 2)])
def test_flash_attention_plain_matches_jax_kernel(monkeypatch, D, Dv, BH):
    """64 queries (an 8x8 grid); Lk = 17 slots x 64 + 12 pointer tokens =
    1100 keys, which the JAX wrapper pads to 1280 (two 640-key blocks of
    its grid). The third slot and four pointer tokens carry the -1e9 key
    bias."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    g = np.random.default_rng(D + Dv)
    Lq, slot, Lk = 64, 64, 17 * 64 + 12
    q = g.standard_normal((BH, Lq, D)).astype(np.float32)
    k = g.standard_normal((BH, Lk, D)).astype(np.float32)
    v = g.standard_normal((BH, Lk, Dv)).astype(np.float32)
    bias = np.zeros(Lk, np.float32)
    bias[2 * slot: 3 * slot] = -1e9
    bias[-4:] = -1e9
    cot = g.standard_normal((BH, Lq, Dv)).astype(np.float32)
    pad_k, pad_v = (-Lk) % 256, (-Dv) % 128
    bias3 = np.concatenate([bias, np.full(pad_k, -1e9, np.float32)])
    bias3 = np.broadcast_to(bias3, (BH, 1, Lk + pad_k))
    block_k = jfa._pick_block(Lk + pad_k, 1024, 128)
    assert (Lk + pad_k) // block_k == 2

    def jfn(q, k, v):
        k = jnp.pad(k, ((0, 0), (0, pad_k), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, pad_k), (0, pad_v)))
        out = jfa._flash_attention_3d(q, k, v, jnp.asarray(bias3), block_k)
        return out[..., :Dv]

    def vjp(args, c):
        out, pull = jax.vjp(jfn, *args)
        return out, pull(c)

    jout, jgrads = jax.jit(vjp)(tuple(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(cot))
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, torch.tensor(bias))
    _close(out, jout, KERNEL_VAL, "out")
    grads = torch.autograd.grad(out, leaves, torch.tensor(cot))
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads, strict=True):
        _close(a, b, GRAD, name)


def test_flash_attention_broadcasts_the_key_bias_over_heads():
    """q [O, H, Lq, D] with a [Lk] key bias and with the same bias given per
    (object, head): the same values."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, HEADS, 16, 128), generator=g)
               for _ in range(3))
    bias = torch.where(torch.rand(16, generator=g) < 0.3, -1e9, 0.0)
    full = tfa.flash_attention(q, k, v, bias.expand(2, HEADS, 16))
    assert torch.equal(tfa.flash_attention(q, k, v, bias), full)
    masked = torch.softmax(q @ k.transpose(-1, -2) / 128 ** 0.5 + bias, -1)
    torch.testing.assert_close(full, masked @ v, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (b) memory attention through the generic flash attention
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("num_heads, kv", [(HEADS, 64), (1, 128)])
def test_flash_memory_attention_matches_jax(num_heads, kv):
    """Two objects, an 8x8 grid, two spatial slots (the second invalid) and
    eight pointer tokens (two invalid), two layers. With two heads the
    cross-attention's v is projected and split; with one head over 128
    channels (too wide for the kproj kernel) v is the raw memory."""
    g = np.random.default_rng(10 + num_heads)
    F, C, O = 8, 256, 2
    HW = F * F
    nsp, nptr = 2 * HW, 8
    Lk = nsp + nptr
    curr = g.standard_normal((O, HW, C)).astype(np.float32)
    mem = g.standard_normal((O, Lk, kv)).astype(np.float32)
    cpos = g.standard_normal((1, HW, C)).astype(np.float32)
    mpos = g.standard_normal((O, Lk, kv)).astype(np.float32)
    valid = np.ones(Lk, bool)
    valid[HW:2 * HW] = False
    valid[-2:] = False
    cot = g.standard_normal((O, HW, C)).astype(np.float32)
    tcfg = tma.MemoryAttentionConfig(num_layers=2, num_heads=num_heads,
                                     kv_in_dim=kv, use_flash=True)
    assert not tma.kproj_eligible(tcfg)
    jcfg = jma.MemoryAttentionConfig(num_layers=2, num_heads=num_heads,
                                     kv_in_dim=kv, use_flash=True)
    params = _numpy_tree(tma.init(torch.Generator().manual_seed(num_heads),
                                  tcfg))

    def jfn(p, cu, m, mp):
        return jma.apply(p, jcfg, cu, m, jnp.asarray(cpos), mp,
                         feat_hw=(F, F), num_spatial_k=nsp,
                         key_valid=jnp.asarray(valid))

    def vjp(args, c):
        out, pull = jax.vjp(jfn, *args)
        return out, pull(c)

    jout, (jgp, jgc, jgm, jgmp) = jax.jit(vjp)(
        (jax.tree.map(jnp.asarray, params), jnp.asarray(curr),
         jnp.asarray(mem), jnp.asarray(mpos)), jnp.asarray(cot))
    leaves = _leaves(params)
    cu, m, mp = (torch.tensor(a).requires_grad_(True)
                 for a in (curr, mem, mpos))
    launches = tfa.flash_attention.launches
    out = tma.apply(_nest(leaves), tcfg, cu, m, torch.tensor(cpos), mp,
                    feat_hw=(F, F), num_spatial_k=nsp,
                    key_valid=torch.from_numpy(valid))
    assert tfa.flash_attention.launches == launches    # plain on the CPU
    _close(out, jout, VAL, "out")
    grads = torch.autograd.grad(out, [cu, m, mp] + list(leaves.values()),
                                torch.tensor(cot))
    want = [jgc, jgm, jgmp] + jax.tree.leaves(jgp)
    for name, a, b in zip(["curr", "memory", "memory_pos"] + list(leaves),
                          grads, want, strict=True):
        _close(a, b, GRAD, name)


# ---------------------------------------------------------------------------
# (c) one memory-only train step with two memory-attention heads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TwoHeadSAM2Config(jsam2.SAM2Config):
    """The JAX ``SAM2Config`` with two memory-attention heads: its
    ``memory_attention_config`` does not forward a head count."""

    @property
    def memory_attention_config(self):
        return dataclasses.replace(super().memory_attention_config,
                                   num_heads=HEADS)


def test_two_head_train_step_matches_jax(monkeypatch):
    """The headline fine-tuning combo with ``memory_attention_num_heads=2``,
    one step: the loss, every trainable leaf's gradient, the updated
    parameters and the frozen ones left as they were. The JAX step returns
    its gradients in place of their global norm (``optax.global_norm`` is
    patched to the identity), so one compile gives all three."""
    jp = jax_tree(KW, seed=8)
    jcfg = _TwoHeadSAM2Config(**KW)
    assert jcfg.memory_attention_config.num_heads == HEADS
    tx = jopt.make_optimizer(jp, {"lr": LR, "type": "AdamW"},
                             {"enabled": False}, total_steps=1000,
                             trainable_modules=TRAINABLE)
    monkeypatch.setattr(optax, "global_norm", lambda g: g)
    jstep = jloop.make_train_step(JVideoModelConfig(sam2=jcfg), JLossConfig(),
                                  tx, trainable_modules=TRAINABLE)
    args = (jloop.TrainState.create(jp, tx),
            _example_clip(IMG, T=T_STEP, O=2, C=2, B=2))
    jstate, jm = jstep.lower(*args).compile(FAST_COMPILE)(*args)
    jgrads = dict(to_param_tree(jax.tree.map(np.asarray, jm["grad_norm"]))
                  .named_parameters())
    jnew = dict(to_param_tree(jax.tree.map(np.asarray, jstate.params))
                .named_parameters())

    tcfg = tsam2.SAM2Config(**KW, memory_attention_num_heads=HEADS)
    assert tcfg.memory_attention_config.num_heads == HEADS
    assert not tma.kproj_eligible(tcfg.memory_attention_config)
    params = to_param_tree(jax.tree.map(np.array, jp))    # a copy
    before = {n: t.detach().clone() for n, t in params.named_parameters()}
    ttx = topt.make_optimizer(params, {"lr": LR, "type": "AdamW"},
                              {"enabled": False}, total_steps=1000,
                              trainable_modules=TRAINABLE)
    tstep = tloop.make_train_step(VideoModelConfig(sam2=tcfg), LossConfig(),
                                  ttx, trainable_modules=TRAINABLE,
                                  device="cpu")
    state, metrics, grads = tstep.with_grads(
        tloop.TrainState.create(params, ttx),
        example_clip(IMG, T=T_STEP, O=2, C=2, B=2))
    assert state.step == 1
    for k in ("total_loss", "loss_mask", "loss_dice", "loss_iou"):
        _close(metrics[k], jm[k], VAL, k)
    assert set(grads) == {n for n in before
                          if n.split(".")[0] not in ("image_encoder",
                                                     "sam_prompt_encoder",
                                                     "sam_mask_decoder",
                                                     "obj_ptr_proj",
                                                     "obj_ptr_tpos_proj")}
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD, name)
    assert all(grads[n].abs().max() > 0 for n in grads
               if n.startswith("memory_attention.layers.0.cross_attn_image."
                               "q_proj"))

    for name, p in params.named_parameters():
        if name not in grads:
            assert torch.equal(p, before[name]), name
            continue
        g = grads[name].abs()
        noise = (grads[name] - torch.from_numpy(jgrads[name].numpy())).abs()
        sure = g > max(1e-3 * float(g.max()), 10 * float(noise.max()),
                       100 * EPS)
        diff = (p.detach() - torch.from_numpy(jnew[name].numpy())).abs()
        assert (diff[sure] <= 1e-2 * LR).all(), name
        assert (diff <= 2 * LR).all(), name
