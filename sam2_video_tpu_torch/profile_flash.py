"""Device time of kernel #7 (the generic flash attention) by key split, on
one NVIDIA GPU.

    python3 -m sam2_video_tpu_torch.profile_flash [--lk 580,1156,2308,4068]
        [--tiles 0,64,32,16,13,10,8,6]

At the two-head memory-attention path's shape (8 objects x 2 heads, 576
queries, head and value width 128, bf16, random inputs from a seed), for
each key count and each number of 64-key tiles per split (0: the wrapper's
rule, ``ops/flash_attention.py`` ``split_tiles``; another value replaces
the rule in this process only), one forward and one backward (autograd
through the kernel, one random cotangent) run under ``torch.profiler``
five times each. It prints the split counts, the device ms per call of
each kernel and their sum, beside ``F.scaled_dot_product_attention``'s on
the same tensors (the yardstick; the port never calls it). Device ms
counts only device-side events, so the host's share of a call, large for
an autograd backward, is not in it.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from .ops import flash_attention as fa

OBJECTS, HEADS, LQ, WIDTH, SEED, CALLS = 8, 2, 576, 128, 0, 5


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lk", default="580,1156,2308,4068")
    ap.add_argument("--tiles", default="0,64,32,16,13,10,8,6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash: no CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator().manual_seed(SEED)
    rule = fa.split_tiles
    BH = OBJECTS * HEADS
    for Lk in (int(x) for x in args.lk.split(",")):
        shapes = ((LQ, WIDTH), (Lk, WIDTH), (Lk, WIDTH), (LQ, WIDTH))
        q, k, v, cot = (torch.randn((OBJECTS, HEADS, *s), generator=gen).to(
            dev, torch.bfloat16) for s in shapes)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib_f, _ = device_ms(lambda: F.scaled_dot_product_attention(*leaves))
        lib_b, _ = device_ms(lambda: torch.autograd.grad(
            lib_out, leaves, cot, retain_graph=True))
        print(f"Lk={Lk}: sdpa forward {lib_f:.4f} ms, backward "
              f"{lib_b:.4f} ms", flush=True)
        for tiles in (int(x) for x in args.tiles.split(",")):
            fa.split_tiles = rule if tiles == 0 else (lambda *a, t=tiles: t)
            try:
                (s_f, _), (s_q, _) = fa.flash_splits(BH, LQ, Lk, WIDTH, WIDTH,
                                                     sms)
                out = fa.flash_attention(*leaves)
                t_f, by_f = device_ms(lambda: fa.flash_attention(*leaves))
                t_b, by_b = device_ms(lambda: torch.autograd.grad(
                    out, leaves, cot, retain_graph=True))
            finally:
                fa.split_tiles = rule
            kernels = " ".join(f"{n} {t:.4f}"
                               for n, t in {**by_f, **by_b}.items())
            print(f"  tiles/split {tiles or 'rule'}: S {s_f} (dq {s_q}); "
                  f"forward {t_f:.4f} ms ({t_f / lib_f:.2f}x sdpa), "
                  f"backward {t_b:.4f} ms ({t_b / lib_b:.2f}x); {kernels}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
