"""The training slice's ops in the PyTorch port held against the JAX
package on the CPU, in float32:

- (a) the plain versions of kernels #3-#5 (``flash_attention_kproj``,
  ``fused_self_block``, ``fused_tail_block``) and their autograd against
  the JAX Pallas kernels run in interpret mode: values and the VJP of one
  numpy cotangent;
- (c) ``merge_objects_to_categories``, ``multi_step_loss`` and
  ``bce_category_loss``;
- (d) the optimizer: three updates on numpy gradients against
  ``make_optimizer`` (AdamW; best.yaml's AMSGrad + weight decay + warm-up
  cosine, with and without gradient accumulation), with a frozen module and
  a trainable one whose gradient is zero.

Sizes as the JAX kernel tests: an 8x8 grid (L = 64), two objects, d 256,
kv 64, 7 memory slots of 64 tokens plus pointer tokens. Tolerances, each
of max(1, max|JAX|) of the tensor: 3e-5 for values and 2e-4 for
gradients (the JAX kernel tests' atol; sums of up to 2048 products in
another order), 1e-6 relative for the optimizer (elementwise float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sam2_video_tpu.ops import flash_attention as jfa
from sam2_video_tpu.ops import memattn_layer_kernel as jmlk
from sam2_video_tpu.ops.position_encoding import \
    axial_rope_table_half as jrope
from sam2_video_tpu.training import losses as jlosses
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.utils import merging as jmerging
from sam2_video_tpu_torch.ops import flash_attention as tfa
from sam2_video_tpu_torch.ops import memattn_layer_kernel as tmlk
from sam2_video_tpu_torch.ops.position_encoding import \
    axial_rope_table_half as trope
from sam2_video_tpu_torch.training import losses as tlosses
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.utils import merging as tmerging

VAL, GRAD = 3e-5, 2e-4
G = 8                       # 8 x 8 grid
L, D, KV, HID = G * G, 256, 64, 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol):
    a = t.detach().double().numpy()
    b = np.asarray(j, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, tol * scale)


def _linear(g, n_in, n_out, scale=0.1):
    return {"weight": (scale * g.standard_normal((n_out, n_in))).astype(
        np.float32),
            "bias": (scale * g.standard_normal(n_out)).astype(np.float32)}


def _ln(g, n):
    return {"weight": (1 + 0.1 * g.standard_normal(n)).astype(np.float32),
            "bias": (0.1 * g.standard_normal(n)).astype(np.float32)}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    """The same arrays as torch leaves that require grad."""
    if isinstance(tree, dict):
        return {k: _ttree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_ttree(v) for v in tree)
    return torch.tensor(tree).requires_grad_(True)


def _tleaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tleaves(v)]
    return [tree]


def _jvjp(fn, args, cot):
    """Values and the VJP of ``cot`` of ``fn(*args)``, compiled whole."""
    def f(args, cot):
        out, pull = jax.vjp(fn, *args)
        return out, pull(cot)
    return jax.jit(f)(args, cot)


# ---------------------------------------------------------------------------
# (a) kernels
# ---------------------------------------------------------------------------


def test_flash_attention_kproj_plain_matches_jax_kernel(monkeypatch):
    """Lk = 19 slots x 64 + 32 pointer tokens = 1248: not a multiple of 256
    (the JAX wrapper pads it to 1280) and two of the JAX kernel's 640-key
    blocks. One invalid slot and some invalid pointer tokens carry the -1e9
    key bias."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    slots, ptr_tokens = 19, 32
    g = np.random.default_rng(slots)
    nsp = slots * L
    Lk = nsp + ptr_tokens
    q = g.standard_normal((2, L, D)).astype(np.float32)
    kin = g.standard_normal((2, Lk, KV)).astype(np.float32)
    v = g.standard_normal((2, Lk, KV)).astype(np.float32)
    wk = _linear(g, KV, D)
    bias = np.zeros(Lk, np.float32)
    bias[2 * L: 3 * L] = -1e9
    bias[-ptr_tokens // 2:] = -1e9
    cot = g.standard_normal((2, L, KV)).astype(np.float32)

    def jfn(q, kin, v, w, b):
        return jfa.flash_attention_kproj(q, kin, v, w, b, jnp.asarray(bias),
                                         nsp, (G, G))[..., :KV]

    jout, jgrads = _jvjp(jfn, tuple(jnp.asarray(a) for a in (
        q, kin, v, wk["weight"], wk["bias"])), jnp.asarray(cot))
    leaves = [torch.tensor(a).requires_grad_(True)
              for a in (q, kin, v, wk["weight"], wk["bias"])]
    out = tfa.flash_attention_kproj(*leaves, torch.tensor(bias), nsp, (G, G))
    _close(out, jout, VAL)
    grads = torch.autograd.grad(out, leaves, torch.tensor(cot))
    for a, b in zip(grads, jgrads, strict=True):
        _close(a, b, GRAD)


def _self_params(g):
    return ({"q": _linear(g, D, D), "k": _linear(g, D, D),
             "v": _linear(g, D, D), "out": _linear(g, D, D)},
            _linear(g, D, D), _ln(g, D), _ln(g, D))


def test_fused_self_block_plain_matches_jax_kernel():
    g = np.random.default_rng(1)
    params = _self_params(g)
    x = g.standard_normal((2, L, D)).astype(np.float32)
    cots = tuple(g.standard_normal((2, L, D)).astype(np.float32)
                 for _ in range(2))
    cos, sin = (np.asarray(t, np.float32) for t in jrope(D, G, G))

    def jfn(p, x):
        return jmlk.fused_self_block(*p, x, jnp.asarray(cos),
                                     jnp.asarray(sin), interpret=True)

    jout, (jgp, jgx) = _jvjp(jfn, (_jtree(params), jnp.asarray(x)),
                             tuple(jnp.asarray(c) for c in cots))
    tp = _ttree(params)
    xt = torch.tensor(x).requires_grad_(True)
    tcos, tsin = trope(D, G, G)
    np.testing.assert_allclose(tcos.numpy(), cos, atol=1e-6)
    out = tmlk.fused_self_block(*tp, xt, tcos, tsin)
    for a, b in zip(out, jout, strict=True):
        _close(a, b, VAL)
    leaves = [xt] + _tleaves(tp)
    grads = torch.autograd.grad(out, leaves, [torch.tensor(c) for c in cots])
    for a, b in zip(grads, [jgx] + jax.tree.leaves(jgp), strict=True):
        _close(a, b, GRAD)


def test_fused_tail_block_plain_matches_jax_kernel():
    """The JAX tail takes the cross-attention output at 128 lanes (zero
    pad); the port's at kv = 64 lanes."""
    g = np.random.default_rng(2)
    params = (_linear(g, KV, D), _linear(g, D, D), _ln(g, D),
              _linear(g, D, HID, 0.05), _linear(g, HID, D, 0.05))
    y = g.standard_normal((2, L, D)).astype(np.float32)
    a = g.standard_normal((2, L, KV)).astype(np.float32)
    a128 = np.concatenate([a, np.zeros_like(a)], axis=-1)
    cot = g.standard_normal((2, L, D)).astype(np.float32)

    def jfn(p, y, a):
        return jmlk.fused_tail_block(*p, y, a, interpret=True)

    jout, (jgp, jgy, jga) = _jvjp(
        jfn, (_jtree(params), jnp.asarray(y), jnp.asarray(a128)),
        jnp.asarray(cot))
    tp = _ttree(params)
    yt, at = (torch.tensor(t).requires_grad_(True) for t in (y, a))
    out = tmlk.fused_tail_block(*tp, yt, at)
    _close(out, jout, VAL)
    grads = torch.autograd.grad(out, [yt, at] + _tleaves(tp),
                                torch.tensor(cot))
    want = [jgy, jga[..., :KV]] + jax.tree.leaves(jgp)
    for x, w in zip(grads, want, strict=True):
        _close(x, w, GRAD)


# ---------------------------------------------------------------------------
# (c) category merge and losses
# ---------------------------------------------------------------------------


def _per_obj(g, T, O, M, S):
    return {"high_res_multimasks": 4 * g.standard_normal((T, O, M, S, S)),
            "ious": g.uniform(0, 1, (T, O, M)),
            "object_score_logits": g.standard_normal((T, O, 1)),
            "high_res_masks": 4 * g.standard_normal((T, O, 1, S, S))}


def test_merge_and_losses_match_jax():
    """Objects 0, 2 in category 0, object 1 in category 2, object 3 padding
    (category 1 empty); frame 1 has no valid target. Values, and the
    gradient of the total loss with respect to the per-object logits."""
    g = np.random.default_rng(3)
    T, O, C, M, S = 3, 4, 3, 2, 16
    per_obj = {k: v.astype(np.float32)
               for k, v in _per_obj(g, T, O, M, S).items()}
    obj_to_cat = np.asarray([0, 2, 0, -1], np.int32)
    targets = g.uniform(size=(T, C, S, S)) > 0.6
    targets[1] = False
    cfg_kw = dict(pred_obj_scores=True, bce_pos_weight=[1.0, 2.0, 0.5])

    def jtotal(po):
        per_cat = jmerging.merge_objects_to_categories(
            po, jnp.asarray(obj_to_cat), C)
        lcfg = jlosses.LossConfig(**cfg_kw)
        ms = jlosses.multi_step_loss(lcfg, per_cat, targets)
        bce = jlosses.bce_category_loss(lcfg, per_cat, targets)
        return ms["total_loss"] + bce["total_loss"], (per_cat, ms, bce)

    (_, (jcat, jms, jbce)), jgrad = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))(_jtree(per_obj))

    tpo = _ttree(per_obj)
    tcat = tmerging.merge_objects_to_categories(
        tpo, torch.tensor(obj_to_cat).long(), C)
    lcfg = tlosses.LossConfig(**cfg_kw)
    tt = torch.tensor(targets)
    tms = tlosses.multi_step_loss(lcfg, tcat, tt)
    tbce = tlosses.bce_category_loss(lcfg, tcat, tt)
    for k in jcat:
        _close(tcat[k], jcat[k], VAL)
    for t, j in ((tms, jms), (tbce, jbce)):
        assert set(t) == set(j)
        for k in j:
            _close(t[k], j[k], VAL)
    # the object scores reach no loss term (loss_class weighs 0): zero
    grads = torch.autograd.grad(tms["total_loss"] + tbce["total_loss"],
                                _tleaves(tpo), allow_unused=True)
    for a, k in zip(grads, sorted(tpo), strict=True):
        _close(torch.zeros_like(tpo[k]) if a is None else a, jgrad[k], GRAD)


# ---------------------------------------------------------------------------
# (d) optimizer
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw": ({"lr": 1e-4, "type": "AdamW"}, {"enabled": False}, 1),
    # configs/best.yaml: AMSGrad, weight decay 0.01, warm-up cosine
    "best": ({"lr": 4e-6, "type": "AdamW", "weight_decay": 0.01,
              "amsgrad": True, "warmup_factor": 0.15},
             {"enabled": True}, 1),
    "best_accumulate2": ({"lr": 4e-6, "type": "AdamW", "weight_decay": 0.01,
                          "amsgrad": True, "warmup_factor": 0.15},
                         {"enabled": True}, 2),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_jax(case):
    """Three updates. The image encoder is frozen; the memory encoder
    trains with a zero gradient (it decays under AdamW's weight decay);
    maskmem_tpos_enc is a bare parameter and trains."""
    opt_cfg, sched_cfg, acc = OPT_CASES[case]
    g = np.random.default_rng(4)
    params = {"image_encoder": {"w": g.standard_normal((4, 3))},
              "memory_attention": {"w": g.standard_normal((5, 2)),
                                   "b": g.standard_normal(5)},
              "memory_encoder": {"w": g.standard_normal((3, 2))},
              "maskmem_tpos_enc": g.standard_normal((2, 1, 1, 4))}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    grads = []
    for _ in range(3):
        gr = jax.tree.map(lambda a: g.standard_normal(a.shape).astype(
            np.float32), params)
        gr["memory_encoder"]["w"] = np.zeros((3, 2), np.float32)
        grads.append(gr)
    trainable = ["memory_attention", "memory_encoder"]
    kw = dict(total_steps=20, trainable_modules=trainable,
              gradient_clip_val=1.0, accumulate_grad_batches=acc)

    tx = jopt.make_optimizer(params, opt_cfg, sched_cfg, **kw)
    jp = _jtree(params)
    state = tx.init(jp)
    upd = jax.jit(tx.update)
    for gr in grads:
        u, state = upd(_jtree(gr), state, jp)
        jp = optax.apply_updates(jp, u)

    flat = {f"{k}.{n}" if isinstance(v, dict) else k: w
            for k, v in params.items()
            for n, w in (v.items() if isinstance(v, dict) else [(None, v)])}

    def flatten(tree):
        return {name: torch.tensor(np.asarray(
            tree[name.split(".")[0]][name.split(".")[1]]
            if "." in name else tree[name])) for name in flat}

    tp = flatten(params)
    ttx = topt.make_optimizer(tp, opt_cfg, sched_cfg, **kw)
    tstate = ttx.init(tp)
    decayed = False
    for gr in grads:
        u, tstate = ttx.update(flatten(gr), tstate, tp)
        decayed |= bool(u["memory_encoder.w"].abs().max() > 0)
        topt.apply_updates(tp, u)
    want = flatten(jax.tree.map(np.asarray, jp))
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    assert torch.equal(tp["image_encoder.w"], flatten(params)[
        "image_encoder.w"])
    # a zero gradient still decays (optax updates every "train" leaf); with
    # accumulation the one emitted update falls on the warm-up's lr of 0
    if acc == 1:
        assert decayed == bool(opt_cfg.get("weight_decay", 0.0))


def test_cosine_schedule_matches_jax():
    """Warm-up, decay and the steps past the end."""
    js = jopt.cosine_schedule_with_warmup(4e-6, 3, 20)
    ts = topt.cosine_schedule_with_warmup(4e-6, 3, 20)
    for step in range(22):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6)
