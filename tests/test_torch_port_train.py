"""The training slice of the PyTorch port held against the JAX package on
the CPU, in float32, with one JAX parameter tree (``jax_tree``) carried
over with ``from_jax_params``:

- (b) memory attention with ``use_flash_attention=True`` (the port's fused
  layer path: the three kernels' plain versions) against JAX
  ``memory_attention.apply``: values and the parameter gradients of one
  numpy cotangent;
- (e) one whole train step, SAM2-tiny at 128 px, T=3, O=2, C=2, B=2, point
  prompts, trainable ``[memory_attention, memory_encoder]``, AdamW at lr
  1e-4, against JAX ``make_train_step``: the loss, every trainable leaf's
  gradient, the updated parameters and the frozen ones left as they were.
  At T=3 the last frame attends a tracked memory (``maskmem_tpos_enc`` row
  0) and a tracked pointer (temporal distance 1) besides the conditioning
  frame's. The JAX step is compiled without XLA's expensive LLVM passes
  (``FAST_COMPILE``): the same program, a few seconds less of the tests'
  budget.

Tolerances: values 1e-4 and gradients 2e-4 of max(1, max|JAX|) of each
tensor (float32 sums of up to 2048 products in another order, through 4
layers). Adam's first step moves a leaf by about lr * sign(g): where |g| is
below 1e-3 of the leaf's max|g| the sign of a float32 gradient is noise,
so updates are compared to 1e-2 lr where |g| > 1e-3 max|g| and to 2 lr
elsewhere. The sign is also noise where |g| is within the two packages'
gradient difference (the float32 sums differ by up to ~1e-5 absolute; the
cross-attention k-projection bias is all noise, since softmax ignores a
shift of all of a query's logits), so |g| must also exceed ten times the
leaf's largest port-vs-JAX gradient difference to count, and 100 times
Adam's epsilon, below which lr g / (|g| + eps) hangs on |g| itself.
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
from sam2_video_tpu.training import loop as jloop
from sam2_video_tpu.training import optimizer as jopt
from sam2_video_tpu.training.losses import LossConfig as JLossConfig
from sam2_video_tpu_torch.convert import to_param_tree
from sam2_video_tpu_torch.data.synthetic import example_clip
from sam2_video_tpu_torch.models import memory_attention as tma
from sam2_video_tpu_torch.models import sam2 as tsam2
from sam2_video_tpu_torch.models.video_model import VideoModelConfig
from sam2_video_tpu_torch.training import loop as tloop
from sam2_video_tpu_torch.training import optimizer as topt
from sam2_video_tpu_torch.training.losses import LossConfig
from test_torch_port_models import jax_tree

IMG = 128
KW = dict(image_size=IMG, compute_dtype="float32", use_flash_attention=True,
          use_activation_checkpoint=False)
TRAINABLE = ["memory_attention", "memory_encoder"]
LR, EPS = 1e-4, 1e-8        # AdamW's learning rate and epsilon
VAL, GRAD = 1e-4, 2e-4
T_STEP = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jp():
    return jax_tree(KW, seed=5)


def _close(t, j, tol, name=""):
    a = t.detach().double().numpy()
    b = np.asarray(j, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (name, err, tol * scale)


def _leaves(tree, prefix=""):
    """name -> torch leaf that requires grad, in ``jax.tree.leaves``
    order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.tensor(np.asarray(v)).requires_grad_(True)
    return out


def _nest(flat):
    tree = {}
    for name, t in flat.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def test_fused_memory_attention_matches_jax(jp):
    """Two objects, an 8x8 grid, two spatial slots (the second invalid) and
    eight pointer tokens (two invalid); the first two of the four layers
    (each layer is the same composition; two keep JAX's compile short)."""
    g = np.random.default_rng(6)
    F, C, D, O = IMG // 16, 256, 64, 2
    HW = F * F
    nsp, nptr = 2 * HW, 8
    curr = g.standard_normal((O, HW, C)).astype(np.float32)
    mem = g.standard_normal((O, nsp + nptr, D)).astype(np.float32)
    cpos = g.standard_normal((1, HW, C)).astype(np.float32)
    mpos = g.standard_normal((O, nsp + nptr, D)).astype(np.float32)
    valid = np.ones(nsp + nptr, bool)
    valid[HW:2 * HW] = False
    valid[-2:] = False
    cot = g.standard_normal((O, HW, C)).astype(np.float32)
    jcfg = dataclasses.replace(jsam2.SAM2Config(**KW).memory_attention_config,
                               num_layers=2)
    tcfg = dataclasses.replace(tsam2.SAM2Config(**KW).memory_attention_config,
                               num_layers=2)
    assert tcfg.use_flash and tma.fused_eligible(tcfg)
    used = {k: v for k, v in jp["memory_attention"].items() if k != "layers"}
    used["layers"] = {k: jp["memory_attention"]["layers"][k] for k in "01"}

    def jfn(p, cu, mp):
        return jma.apply(p, jcfg, cu, jnp.asarray(mem), jnp.asarray(cpos),
                         mp, feat_hw=(F, F), num_spatial_k=nsp,
                         key_valid=jnp.asarray(valid))

    def vjp(p, cu, mp, c):
        out, pull = jax.vjp(jfn, p, cu, mp)
        return out, pull(c)

    jout, (jgp, jgc, jgm) = jax.jit(vjp)(
        jax.tree.map(jnp.asarray, used), jnp.asarray(curr),
        jnp.asarray(mpos), jnp.asarray(cot))
    leaves = _leaves(used)
    cu, mp = (torch.tensor(a).requires_grad_(True) for a in (curr, mpos))
    out = tma.apply(_nest(leaves), tcfg, cu, torch.tensor(mem),
                    torch.tensor(cpos), mp, feat_hw=(F, F),
                    num_spatial_k=nsp, key_valid=torch.from_numpy(valid))
    _close(out, jout, VAL)
    grads = torch.autograd.grad(out, [cu, mp] + list(leaves.values()),
                                torch.tensor(cot))
    want = [jgc, jgm] + jax.tree.leaves(jgp)
    for name, a, b in zip(["curr", "memory_pos"] + list(leaves), grads, want,
                          strict=True):
        _close(a, b, GRAD, name)


def test_fused_memory_attention_takes_any_grid_on_the_cpu(jp):
    """A 6x6 grid: 36 tokens, not a multiple of the block kernels' 32 (a
    CUDA tensor raises there). On a CPU tensor the fused composition, the
    kernels' plain versions, runs and equals the plain layers
    (``use_flash=False``, held against JAX in test_torch_port_models.py):
    values and the gradients of one cotangent."""
    g = np.random.default_rng(7)
    F, C, D, O = 6, 256, 64, 2
    HW = F * F
    nsp, nptr = 2 * HW, 4
    curr, cot = (g.standard_normal((O, HW, C)).astype(np.float32)
                 for _ in range(2))
    mem, mpos = (g.standard_normal((O, nsp + nptr, D)).astype(np.float32)
                 for _ in range(2))
    cpos = g.standard_normal((1, HW, C)).astype(np.float32)
    res = []
    for flash in (True, False):
        cfg = dataclasses.replace(
            tsam2.SAM2Config(**KW).memory_attention_config, num_layers=2,
            use_flash=flash)
        assert tma.fused_eligible(cfg) == flash
        leaves = _leaves({k: jp["memory_attention"]["layers"][k]
                          for k in "01"})
        params = {"layers": _nest(leaves),
                  "norm": _nest(_leaves(jp["memory_attention"]["norm"]))}
        cu = torch.tensor(curr).requires_grad_(True)
        out = tma.apply(params, cfg, cu, torch.tensor(mem),
                        torch.tensor(cpos), torch.tensor(mpos),
                        feat_hw=(F, F), num_spatial_k=nsp)
        res.append((out, torch.autograd.grad(
            out, [cu] + list(leaves.values()), torch.tensor(cot))))
    (fused, fused_grads), (plain, plain_grads) = res
    _close(fused, plain.detach().numpy(), VAL)
    for a, b in zip(fused_grads, plain_grads, strict=True):
        _close(a, b.numpy(), GRAD)


def test_train_step_matches_jax(jp, monkeypatch):
    """The headline fine-tuning combo, one step. The JAX step returns its
    gradients in place of their global norm (``optax.global_norm`` is
    patched to the identity), so one compile gives loss, gradients and
    updated parameters."""
    jcfg = jsam2.SAM2Config(**KW)
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

    tcfg = tsam2.SAM2Config(**KW)
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
        if name.startswith(("memory_encoder.", "no_obj_embed_spatial")):
            assert not g.any(), name        # feeds the detached bank only
    assert grads["maskmem_tpos_enc"].abs().max() > 0

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


def test_forward_train_attends_the_valid_prefix(jp, monkeypatch):
    """The static-prefix frame loop of the JAX package
    (models/video_model.py:176-240): frame t attends the conditioning slot
    and then the min(t - 1, 6) newest tracked memories, newest first, with
    maskmem_tpos_enc rows [6, 0, 1, ...], and the conditioning pointer and
    the min(t - 1, P - 1) newest pointers at temporal distances
    [t, 1, 2, ...]; each bank entry is the memory encoder's output of that
    frame, detached."""
    T = 9
    cfg = tsam2.SAM2Config(**KW)
    params = to_param_tree(jax.tree.map(np.array, jp))
    mems, calls = [], []
    encode = tsam2.encode_new_memory
    fuse = tsam2.fuse_memory

    def record_encode(*args, **kw):
        out = encode(*args, **kw)
        mems.append(out[0])
        return out

    def record_fuse(p, c, layout, curr, curr_pos, spatial_mem, valid,
                    mem_pos, tpos, ptrs, ptr_valid, ptr_tpos, **kw):
        calls.append((layout, spatial_mem, valid, tpos, ptrs, ptr_valid,
                      ptr_tpos, kw["t_diff_max"]))
        return fuse(p, c, layout, curr, curr_pos, spatial_mem, valid,
                    mem_pos, tpos, ptrs, ptr_valid, ptr_tpos, **kw)

    monkeypatch.setattr(tsam2, "encode_new_memory", record_encode)
    monkeypatch.setattr(tsam2, "fuse_memory", record_fuse)
    clip = example_clip(IMG, T=T, O=2, C=2)
    with torch.no_grad():
        from sam2_video_tpu_torch.models.video_model import forward_train
        per_obj, per_cat = forward_train(params, VideoModelConfig(sam2=cfg),
                                         clip, training=True)
    assert per_obj["high_res_masks"].shape == (T, 2, 1, IMG, IMG)
    assert per_cat["ious"].shape == (T, 2, 1)
    assert len(calls) == T - 1 and len(mems) == T
    HW = cfg.num_spatial_tokens
    for t, (layout, spatial, valid, tpos, ptrs, pvalid, ptpos,
            tdm) in enumerate(calls, start=1):
        n = min(t - 1, cfg.num_maskmem - 1)
        assert valid is None and pvalid is None and tdm == T - 1
        assert layout == tsam2.MemoryLayout(1 + n, HW, 1 + min(t - 1, T - 1),
                                            cfg.ptr_tokens_per_obj)
        assert tpos.tolist() == [cfg.num_maskmem - 1] + list(range(n))
        assert ptpos.tolist() == [float(t)] + [float(i + 1)
                                               for i in range(t - 1)]
        assert ptrs.shape[0] == 1 + (t - 1)
        newest_first = [mems[0]] + [mems[t - 1 - j] for j in range(n)]
        for slot, m in zip(spatial, newest_first, strict=True):
            assert torch.equal(slot, m.reshape(2, HW, -1).float())


def test_eval_step_reports_the_train_losses(jp):
    """make_eval_step: the batched losses without gradient or update, with
    the train step's keys; the parameters do not change."""
    cfg = tsam2.SAM2Config(**KW)
    params = to_param_tree(jax.tree.map(np.array, jp))
    before = {n: t.clone() for n, t in params.named_parameters()}
    step = tloop.make_eval_step(VideoModelConfig(sam2=cfg), LossConfig(),
                                device="cpu")
    metrics = step(params, example_clip(IMG, T=2, O=2, C=2, B=1))
    assert set(metrics) == {"loss_mask", "loss_dice", "loss_iou",
                            "loss_class", "total_loss",
                            "frames_without_valid"}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert metrics["total_loss"] > 0
    for n, t in params.named_parameters():
        assert torch.equal(t, before[n]), n
