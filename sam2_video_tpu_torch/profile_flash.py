"""Device time of the flash attention kernels by key split, on one NVIDIA
GPU: #7 (the generic flash attention) by default, #3
(``flash_attention_kproj``) with ``--kproj``.

    python3 -m sam2_video_tpu_torch.profile_flash [--lk 580,1156,2308,4068]
        [--tiles 0,64,32,16,13,10,8,6]
    python3 -m sam2_video_tpu_torch.profile_flash --kproj
        [--lk 580,1156,2308,4068,4096] [--tiles 0,...]

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
SLOT = 24                       # #3: one memory slot is 24 x 24 (384 px)


def device_ms(fn) -> tuple[float, dict]:
    """(summed device ms per call, device ms per call by kernel)."""
    fn()
    for _ in range(3):   # a trace now and then comes back with no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        by = {e.key.split("(")[0].removeprefix("void "):
              e.self_device_time_total / 1e3 / CALLS
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        if by:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kproj", action="store_true",
                    help="kernel #3 instead of #7")
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
    if args.kproj:
        profile_kproj(lks, tiles, dev, sms, gen)
    else:
        profile_flash(lks, tiles, dev, sms, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
