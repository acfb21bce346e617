"""Device time of the port's kernels on one NVIDIA GPU: #7 (the generic
flash attention) by key split by default, #3 (``flash_attention_kproj``)
with ``--kproj``, #4 and #5 (the memory-attention layer blocks) with
``--memattn``, #6 (the Hiera block backward) with ``--hiera-bwd``, #1 (the
Hiera block forward) with ``--hiera-fwd``, #2 (the memory encoder) with
``--memenc`` and #8 (the two-way decoder block) with ``--twoway``.

    python3 -m sam2_video_tpu_torch.profile_flash [--lk 580,1156,2308,4068]
        [--tiles 0,64,32,16,13,10,8,6]
    python3 -m sam2_video_tpu_torch.profile_flash --kproj
        [--lk 580,1156,2308,4068,4096] [--tiles 0,...]
    python3 -m sam2_video_tpu_torch.profile_flash --memattn
    python3 -m sam2_video_tpu_torch.profile_flash --hiera-bwd
    python3 -m sam2_video_tpu_torch.profile_flash --hiera-fwd [--frames 10]
    python3 -m sam2_video_tpu_torch.profile_flash --memenc
    python3 -m sam2_video_tpu_torch.profile_flash --twoway

``--hiera-fwd``: ``fused_block`` on each of the 12 blocks of the tiny
trunk (the operand pack made beforehand, as ``models/sam2.py`` ``prepare``
does) and the plain block, at ``--frames`` frames of 384 px (10: the train
steps' trunk forward; 8: one serving chunk), ``synthetic_params`` weights:
device ms and device operations per block, per geometry class (the mean
over its blocks) and per trunk pass (the sum), and the kernels by name.

``--memenc``: ``fused_memory_encoder`` and its plain version at 8 objects
of 384 px (masks [8, 384, 384, 1] through the scaled sigmoid, projected
pixels [8, 24, 24, 256], bf16; ``synthetic_params`` weights through
``prepare``): device ms and device operations per call, and the kernels
by name.

``--twoway``: ``fused_twoway_block`` forward and backward (autograd, one
random cotangent) and the plain bf16 block, the decoder's second block at
the fused step's shape (8 objects, 8 tokens, 576 image keys), its packed
operands made beforehand: device ms and device operations per call.

``--hiera-fwd``, ``--memenc`` and ``--twoway`` use the public API only, so
they also time an older tree of the package (copy this file into it).

``--memattn``: ``fused_self_block`` and ``fused_tail_block`` forward and
backward (autograd through the kernel, random cotangents) at the training
shape (8 objects, 576 tokens, d 256, memory 64, hidden 2048, bf16 inputs,
float32 weight leaves from a seed), beside their plain PyTorch versions:
device ms per call, device operations per call and the kernels by name.
It uses the wrappers' public functions only, so it also times an older
tree of the package (copy this file into it).

``--hiera-bwd``: one backward (B1 + B2) of each of the 12 blocks of the
tiny trunk through ``fused_block_trainable`` (autograd through the
kernel's Function, one random cotangent) and through the plain bf16 block,
at the all-trainable step's shape (10 frames of 384 px, ``synthetic_params``
weights as float32 leaves): device ms and device operations per call,
per geometry class (the mean over its blocks) and per trunk pass (the sum
over the 12 blocks), and the kernels by name. Also kernel #1's forward
(``fused_block`` with the block's operand pack made beforehand, as
``models/sam2.py`` ``prepare`` does) and the plain forward at the same
shape, per trunk pass: the train steps' trunk forward. Public API only, so
it also times an older tree of the package (copy this file into it).

#7: at the two-head memory-attention path's shape (8 objects x 2 heads, 576
queries, head and value width 128). #3: at the one-head path's (8 objects,
576 queries of a 24 x 24 slot, q width 256, memory 64; Lk = slots x 576 +
pointer tokens: 580 is frame 1 of a training clip, 4068 frame 9, 4096
serving with two of seven slots masked by a -1e9 key bias; other key counts
take 4 pointer tokens). bf16, random inputs from a seed. For each key count
and each number of 64-key tiles per split (0: the wrapper's rule,
``ops/flash_attention.py`` ``split_tiles``; another value replaces the rule
in this process only), one forward and one backward (autograd
through the kernel, one random cotangent) run under ``torch.profiler`` five
times each. It prints the split counts, the device ms per call of each
kernel and their sum, beside ``F.scaled_dot_product_attention``'s on the
same tensors (for #3 on the keys projected and rotated beforehand, 4-D
[O, 1, L, 256], a boolean mask where keys are masked; the yardstick, which
the port never calls) and, for #3, beside the plain PyTorch version's
and #7's on the same stored keys (bf16 k, one q k^T product: the attention
part of a design that projects the keys once into device memory).
Device ms counts only device-side events, so the host's share of a call,
large for an autograd backward, is not in it. ``--kproj`` also runs
against an older tree of the package that lacks #3's split rule (it then
times that tree's kernel as it is).
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from .ops import flash_attention as fa

OBJECTS, HEADS, LQ, WIDTH, SEED, CALLS = 8, 2, 576, 128, 0, 5
FRAMES = 10                     # #6: the all-trainable step's frames per call
SLOT = 24                       # #3: one memory slot is 24 x 24 (384 px)


def device_ms(fn, counts: dict | None = None) -> tuple[float, dict]:
    """(summed device ms per call, device ms per call by kernel); with
    ``counts``, the device operations per call by kernel go there."""
    fn()
    for _ in range(3):   # a trace now and then comes back with no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        by = {e.key.split("(")[0].removeprefix("void "):
              e.self_device_time_total / 1e3 / CALLS for e in evs}
        if by:
            if counts is not None:
                counts.update({e.key.split("(")[0].removeprefix("void "):
                               e.count / CALLS for e in evs})
            return sum(by.values()), by
    raise RuntimeError("profile_flash: the profiler recorded no device event")


def _fwd_bwd(fn, leaves, cot) -> tuple[float, dict, float, dict]:
    out = fn(*leaves)
    t_f, by_f = device_ms(lambda: fn(*leaves))
    t_b, by_b = device_ms(lambda: torch.autograd.grad(
        out, leaves, cot, retain_graph=True))
    return t_f, by_f, t_b, by_b


def _kernels(*by) -> str:
    return " ".join(f"{n} {t:.4f}" for d in by for n, t in d.items())


def profile_flash(lks, tiles_list, dev, sms, gen) -> None:
    rule = fa.split_tiles
    BH = OBJECTS * HEADS
    for Lk in lks:
        shapes = ((LQ, WIDTH), (Lk, WIDTH), (Lk, WIDTH), (LQ, WIDTH))
        q, k, v, cot = (torch.randn((OBJECTS, HEADS, *s), generator=gen).to(
            dev, torch.bfloat16) for s in shapes)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_f, _, lib_b, _ = _fwd_bwd(F.scaled_dot_product_attention,
                                      leaves, cot)
        print(f"Lk={Lk}: sdpa forward {lib_f:.4f} ms, backward "
              f"{lib_b:.4f} ms", flush=True)
        for tiles in tiles_list:
            fa.split_tiles = rule if tiles == 0 else \
                (lambda *a, t=tiles, **k: t)
            try:
                (s_f, _), (s_q, _) = fa.flash_splits(BH, LQ, Lk, WIDTH, WIDTH,
                                                     sms)
                t_f, by_f, t_b, by_b = _fwd_bwd(fa.flash_attention, leaves,
                                                cot)
            finally:
                fa.split_tiles = rule
            print(f"  tiles/split {tiles or 'rule'}: S {s_f} (dq {s_q}); "
                  f"forward {t_f:.4f} ms ({t_f / lib_f:.2f}x sdpa), "
                  f"backward {t_b:.4f} ms ({t_b / lib_b:.2f}x); "
                  f"{_kernels(by_f, by_b)}", flush=True)


def _kproj_inputs(Lk, dev, gen):
    """q, kin, v, Wk, bk, the key bias (or None), num_spatial and the
    cotangent of #3 at Lk keys."""
    HW = SLOT * SLOT
    slots, masked = {4068: (7, False), 4096: (7, True)}.get(
        Lk, ((Lk - 4) // HW, False))
    nsp = slots * HW
    rnd = lambda *s: torch.randn(s, generator=gen).to(  # noqa: E731
        dev, torch.bfloat16)
    x = [rnd(OBJECTS, LQ, 256), rnd(OBJECTS, Lk, 64), rnd(OBJECTS, Lk, 64),
         rnd(256, 64) * 0.125, rnd(256) * 0.1]
    bias = None
    if masked:
        bias = torch.zeros(Lk, device=dev)
        bias[2 * HW: 4 * HW] = -1e9
    return x, bias, nsp, rnd(OBJECTS, LQ, 64)


def _kproj_sdpa(x, bias, nsp):
    """q and the keys #3 would project (k = RoPE(kin Wk^T + bk), bf16), v
    and a boolean mask, 4-D [O, 1, L, .] for sdpa's flash backends."""
    q, kin, v, wk, bk = x
    with torch.no_grad():
        cos, sin = fa.kproj_rope_tables(256, (SLOT, SLOT), 10000.0,
                                        torch.bfloat16, q.device)
        Lk = kin.shape[1]
        reps = nsp // cos.shape[0]
        c = torch.cat([cos.repeat(reps, 1), cos.new_ones((Lk - nsp, 128))])
        s = torch.cat([sin.repeat(reps, 1), sin.new_zeros((Lk - nsp, 128))])
        kpre = kin.float() @ wk.float().t() + bk.float()
        k1, k2 = kpre[..., :128], kpre[..., 128:]
        k = torch.cat([k1 * c - k2 * s, k2 * c + k1 * s], -1).to(q.dtype)
    mask = None if bias is None else (bias == 0)[None, None, None, :]
    return [q[:, None], k[:, None], v[:, None]], mask


def profile_kproj(lks, tiles_list, dev, sms, gen) -> None:
    rule = fa.split_tiles
    plan = getattr(fa, "kproj_plan", None)      # absent in older trees
    for Lk in lks:
        x, bias, nsp, cot = _kproj_inputs(Lk, dev, gen)
        leaves = [t.clone().requires_grad_(True) for t in x]
        s_in, mask = _kproj_sdpa(x, bias, nsp)
        s_leaves = [t.clone().requires_grad_(True) for t in s_in]
        lib_f, _, lib_b, _ = _fwd_bwd(
            lambda *a: F.scaled_dot_product_attention(*a, attn_mask=mask),
            s_leaves, cot[:, None])
        st_f, _, st_b, _ = _fwd_bwd(
            lambda *a: fa.flash_attention(*a, bias), s_leaves, cot[:, None])
        geo = (bias, nsp, (SLOT, SLOT))
        pl_f, _, pl_b, _ = _fwd_bwd(
            lambda *a: fa.flash_attention_kproj_plain(*a, *geo), leaves, cot)
        tag = "masked" if bias is not None else "no bias"
        print(f"Lk={Lk} (num_spatial {nsp}, {tag}): "
              f"sdpa forward {lib_f:.4f} ms, backward {lib_b:.4f} ms; "
              f"#7 on the stored keys forward {st_f:.4f} ms, backward "
              f"{st_b:.4f} ms; plain forward {pl_f:.4f} ms, backward "
              f"{pl_b:.4f} ms", flush=True)
        for tiles in tiles_list if plan else [0]:
            fa.split_tiles = rule if tiles == 0 else \
                (lambda *a, t=tiles, **k: t)
            try:
                p = plan(OBJECTS, LQ, Lk, (SLOT, SLOT), sms) if plan else None
                t_f, by_f, t_b, by_b = _fwd_bwd(
                    lambda *a: fa.flash_attention_kproj(*a, *geo), leaves,
                    cot)
            finally:
                fa.split_tiles = rule
            how = (f"S {p.fwd[0]} (dq {p.dq[0]}, {p.dq_warpgroups} "
                   f"warpgroups), dWk blocks {p.dw[0]}"
                   if p else "this tree's kernel")
            print(f"  tiles/split {tiles or 'rule'}: {how}; forward "
                  f"{t_f:.4f} ms ({t_f / lib_f:.2f}x sdpa), backward "
                  f"{t_b:.4f} ms ({t_b / lib_b:.2f}x); "
                  f"{_kernels(by_f, by_b)}", flush=True)


def _memattn_args(dev, gen, N=OBJECTS, L=LQ, KV=64, HID=2048):
    """Leaves (float32, requiring grad), bf16 inputs and cotangents of
    fused_self_block and fused_tail_block at the training shape."""
    from .ops.position_encoding import axial_rope_table_half

    D = 256
    rnd = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    leaf = lambda t: t.to(dev).requires_grad_(True)  # noqa: E731

    def lin(o, i):
        return {"weight": leaf(rnd(o, i) / i ** 0.5),
                "bias": leaf(0.1 * rnd(o))}

    def ln():
        return {"weight": leaf(1 + 0.1 * rnd(D)), "bias": leaf(0.1 * rnd(D))}

    act = lambda *s: rnd(*s).to(dev, torch.bfloat16)  # noqa: E731
    side = int(L ** 0.5)
    cos, sin = axial_rope_table_half(D, side, side, device=dev)
    self_p = ({"q": lin(D, D), "k": lin(D, D), "v": lin(D, D),
               "out": lin(D, D)}, lin(D, D), ln(), ln())
    tail_p = (lin(D, KV), lin(D, D), ln(), lin(HID, D), lin(D, HID))
    x, y, a = act(N, L, D), act(N, L, D), act(N, L, KV)
    return (self_p, x, cos, sin, [act(N, L, D), act(N, L, D)],
            tail_p, y, a, act(N, L, D))


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def profile_memattn(dev, gen) -> None:
    from .ops import memattn_layer_kernel as mlk

    (self_p, x, cos, sin, self_cots, tail_p, y, a,
     tail_cot) = _memattn_args(dev, gen)
    xl, yl, al = (t.clone().requires_grad_(True) for t in (x, y, a))
    cases = (
        ("fused_self_block", lambda f: f(*self_p, xl, cos, sin),
         mlk.fused_self_block, mlk.fused_self_block_plain,
         [xl] + _tree_leaves(self_p), self_cots),
        ("fused_tail_block", lambda f: f(*tail_p, yl, al),
         mlk.fused_tail_block, mlk.fused_tail_block_plain,
         [yl, al] + _tree_leaves(tail_p), [tail_cot]))
    for name, call, kernel, plain, inputs, cots in cases:
        for kind, fn in (("kernel", kernel), ("plain", plain)):
            outs = call(fn)
            outs = outs if isinstance(outs, tuple) else (outs,)
            n_f, n_b = {}, {}
            t_f, by_f = device_ms(lambda: call(fn), n_f)
            t_b, by_b = device_ms(lambda: torch.autograd.grad(
                outs, inputs, cots, retain_graph=True), n_b)
            print(f"{name} {kind}: forward {t_f:.4f} ms, "
                  f"{sum(n_f.values()):g} device ops; backward {t_b:.4f} "
                  f"ms, {sum(n_b.values()):g} device ops", flush=True)
            if kind == "kernel":
                print(f"  forward: {_kernels(by_f)}", flush=True)
                print(f"  backward: {_kernels(by_b)}", flush=True)


def profile_hiera_bwd(dev, gen) -> None:
    from .data.synthetic import synthetic_params
    from .models import sam2 as sam2_mod
    from .ops import hiera_block_bwd as hbb
    from .ops import hiera_block_kernel as hbk

    cfg = sam2_mod.SAM2Config(image_size=384)
    tcfg = cfg.trunk_config
    trunk = synthetic_params(cfg, seed=SEED)["image_encoder"]["trunk"]
    H = cfg.image_size // 4
    total = {k: [0.0, 0.0] for k in ("kernel", "plain", "#1", "#1 plain")}
    classes: dict = {}
    for i, spec in enumerate(tcfg.block_specs()):
        geom = hbb.geometry(spec, H, H)
        w = [t.detach().to(dev).requires_grad_(True)
             for t in hbb.leaves(trunk["blocks"][str(i)], spec)]
        x = torch.randn((FRAMES, H, H, spec["dim"]), generator=gen).to(
            dev, torch.bfloat16).requires_grad_(True)
        p = hbb.block_params(w, spec)
        with torch.no_grad():
            p1 = dict(p, _ops=hbk.pack(p, spec))
            for kind, fn in (("#1", hbk.fused_block),
                             ("#1 plain", hbk.fused_block_plain)):
                n = {}
                t, _ = device_ms(lambda: fn(p1, x, spec, tcfg.q_stride,
                                            tcfg.mlp_ratio), n)
                total[kind][0] += t
                total[kind][1] += sum(n.values())
        cot = None
        for kind, fn in (("kernel", hbb.fused_block_trainable),
                         ("plain", hbb.fused_block_trainable_plain)):
            out = fn(p, x, spec, tcfg.q_stride, tcfg.mlp_ratio)
            if cot is None:
                cot = torch.randn(out.shape, generator=gen).to(
                    dev, torch.bfloat16)
            n = {}
            t, by = device_ms(lambda: torch.autograd.grad(
                out, [x] + w, cot, retain_graph=True), n)
            ops = sum(n.values())
            total[kind][0] += t
            total[kind][1] += ops
            c = classes.setdefault(geom, {"kernel": [], "plain": []})
            c[kind].append((t, ops))
            print(f"block {i:2d} {geom} {kind}: backward {t:.4f} ms, "
                  f"{ops:g} device ops", flush=True)
            if kind == "kernel":
                print(f"  {_kernels(by)}", flush=True)
            del out
        if spec["q_pool"]:
            H //= 2
    for geom, c in classes.items():
        k = [sum(v) / len(c["kernel"]) for v in zip(*c["kernel"])]
        p = [sum(v) / len(c["plain"]) for v in zip(*c["plain"])]
        print(f"class {geom} ({len(c['kernel'])} blocks): kernel "
              f"{k[0]:.4f} ms, {k[1]:g} device ops; plain {p[0]:.4f} ms, "
              f"{p[1]:g} device ops", flush=True)
    print(f"trunk pass ({FRAMES} frames, 12 blocks): kernel "
          f"{total['kernel'][0]:.4f} ms, {total['kernel'][1]:g} device ops;"
          f" plain {total['plain'][0]:.4f} ms, {total['plain'][1]:g} device"
          " ops", flush=True)
    print(f"trunk pass forward, kernel #1 ({FRAMES} frames, 12 blocks): "
          f"{total['#1'][0]:.4f} ms, {total['#1'][1]:g} device ops; plain "
          f"{total['#1 plain'][0]:.4f} ms, {total['#1 plain'][1]:g} device "
          "ops", flush=True)


def profile_hiera_fwd(dev, gen, frames: int) -> None:
    from .data.synthetic import synthetic_params
    from .models import sam2 as sam2_mod
    from .ops import hiera_block_kernel as hbk

    cfg = sam2_mod.SAM2Config(image_size=384, compute_dtype="bfloat16")
    tcfg = cfg.trunk_config
    trunk = sam2_mod.prepare(synthetic_params(cfg, seed=SEED).to(dev), cfg)[
        "image_encoder"]["trunk"]
    H = cfg.image_size // 4
    total = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
    classes: dict = {}
    for i, spec in enumerate(tcfg.block_specs()):
        ws = spec["window_size"]
        geom = (f"{H}x{H} {spec['dim']}->{spec['dim_out']} "
                + ("global" if ws == 0 else f"window {ws}")
                + (", q-pool" if spec["q_pool"] else ""))
        bp = trunk["blocks"][str(i)]
        x = torch.randn((frames, H, H, spec["dim"]), generator=gen).to(
            dev, torch.bfloat16)
        for kind, fn in (("kernel", hbk.fused_block),
                         ("plain", hbk.fused_block_plain)):
            n = {}
            with torch.no_grad():
                t, by = device_ms(lambda: fn(bp, x, spec, tcfg.q_stride,
                                             tcfg.mlp_ratio), n)
            ops = sum(n.values())
            total[kind][0] += t
            total[kind][1] += ops
            classes.setdefault(geom, {"kernel": [], "plain": []})[
                kind].append((t, ops))
            print(f"block {i:2d} {geom} #1 {kind}: forward {t:.4f} ms, "
                  f"{ops:g} device ops", flush=True)
            if kind == "kernel":
                print(f"  {_kernels(by)}", flush=True)
        if spec["q_pool"]:
            H //= 2
    for geom, c in classes.items():
        k = [sum(v) / len(c["kernel"]) for v in zip(*c["kernel"])]
        p = [sum(v) / len(c["plain"]) for v in zip(*c["plain"])]
        print(f"class {geom} ({len(c['kernel'])} blocks): #1 {k[0]:.4f} ms, "
              f"{k[1]:g} device ops; plain {p[0]:.4f} ms, {p[1]:g} device "
              "ops", flush=True)
    print(f"trunk pass forward, kernel #1 ({frames} frames, 12 blocks): "
          f"{total['kernel'][0]:.4f} ms, {total['kernel'][1]:g} device ops; "
          f"plain {total['plain'][0]:.4f} ms, {total['plain'][1]:g} device "
          "ops", flush=True)


def profile_memenc(dev, gen) -> None:
    from .data.synthetic import synthetic_params
    from .models import sam2 as sam2_mod
    from .ops import common as nn
    from .ops import memory_encoder_kernel as mek

    cfg = sam2_mod.SAM2Config(image_size=384, compute_dtype="bfloat16")
    mcfg = cfg.memory_encoder_config
    p = sam2_mod.prepare(synthetic_params(cfg, seed=SEED).to(dev), cfg)[
        "memory_encoder"]
    S, h = cfg.image_size, cfg.feat_size
    masks = (torch.sigmoid(8.0 * torch.randn((OBJECTS, S, S, 1),
                                             generator=gen))
             * 20.0 - 10.0).to(dev, torch.bfloat16)
    pix = torch.randn((OBJECTS, h, h, 256), generator=gen).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        pix_proj = nn.conv2d(p["pix_feat_proj"], pix)
        for kind, fn in (("kernel", mek.fused_memory_encoder),
                         ("plain", mek.fused_memory_encoder_plain)):
            n = {}
            t, by = device_ms(lambda: fn(p, mcfg, pix_proj, masks), n)
            print(f"fused_memory_encoder {kind} ({OBJECTS} objects, {S} px): "
                  f"{t:.4f} ms, {sum(n.values()):g} device ops", flush=True)
            if kind == "kernel":
                print(f"  {_kernels(by)}", flush=True)


def profile_twoway(dev, gen) -> None:
    from .data.synthetic import synthetic_params
    from .models import sam2 as sam2_mod
    from .ops import common as nn
    from .ops import twoway_kernel as twk

    cfg = sam2_mod.SAM2Config(image_size=384)
    layer = synthetic_params(cfg, seed=SEED).to(dev)["sam_mask_decoder"][
        "transformer"]["layers"]["1"]
    O, N, HW = OBJECTS, 8, 576

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    x = [rnd(O, N, 256), rnd(O, HW, 256), rnd(O, N, 256), rnd(HW, 256)]
    cots = [rnd(O, N, 256), rnd(O, HW, 256)]
    for kind, fn in (("kernel", twk.fused_twoway_block),
                     ("plain", twk.twoway_block_plain)):
        w = [t.detach().clone().requires_grad_(True)
             for t in twk.leaves(layer)]
        xl = [t.clone().requires_grad_(True) for t in x]
        t = twk.block_params(w)
        if kind == "kernel":
            with torch.no_grad():
                t["_ops"] = twk.pack(t)
        else:                          # bf16 copies inside the graph
            nn.add_compute_casts(t, torch.bfloat16)
        outs = fn(t, *xl, False)
        n_f, n_b = {}, {}
        t_f, by_f = device_ms(lambda: fn(t, *xl, False), n_f)
        t_b, by_b = device_ms(lambda: torch.autograd.grad(
            outs, w + xl, cots, retain_graph=True), n_b)
        print(f"fused_twoway_block {kind} (O={O} N={N} HW={HW}): forward "
              f"{t_f:.4f} ms, {sum(n_f.values()):g} device ops; backward "
              f"{t_b:.4f} ms, {sum(n_b.values()):g} device ops", flush=True)
        if kind == "kernel":
            print(f"  forward: {_kernels(by_f)}", flush=True)
            print(f"  backward: {_kernels(by_b)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kproj", action="store_true",
                    help="kernel #3 instead of #7")
    ap.add_argument("--memattn", action="store_true",
                    help="kernels #4 and #5 instead of #7")
    ap.add_argument("--hiera-bwd", action="store_true",
                    help="kernel #6 instead of #7")
    ap.add_argument("--hiera-fwd", action="store_true",
                    help="kernel #1 instead of #7")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames per call of --hiera-fwd")
    ap.add_argument("--memenc", action="store_true",
                    help="kernel #2 instead of #7")
    ap.add_argument("--twoway", action="store_true",
                    help="kernel #8 instead of #7")
    ap.add_argument("--lk", default=None)
    ap.add_argument("--tiles", default="0,64,32,16,13,10,8,6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash: no CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator().manual_seed(SEED)
    lk = args.lk or ("580,1156,2308,4068,4096" if args.kproj
                     else "580,1156,2308,4068")
    lks = [int(x) for x in lk.split(",")]
    tiles = [int(x) for x in args.tiles.split(",")]
    if args.hiera_fwd:
        profile_hiera_fwd(dev, gen, args.frames)
    elif args.memenc:
        profile_memenc(dev, gen)
    elif args.twoway:
        profile_twoway(dev, gen)
    elif args.hiera_bwd:
        profile_hiera_bwd(dev, gen)
    elif args.memattn:
        profile_memattn(dev, gen)
    elif args.kproj:
        profile_kproj(lks, tiles, dev, sms, gen)
    else:
        profile_flash(lks, tiles, dev, sms, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
