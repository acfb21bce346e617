"""Where the serving path's device time goes, on one NVIDIA GPU.

    python3 -m sam2_video_tpu_torch.profile_serving [--fused-twoway]
        [--memory-attention-heads N]

Builds the SAM2-tiny 384-px bf16 predictor (``synthetic_params`` weights,
the usual use_flash_attention=True; with ``--fused-twoway`` the decoder's
two-way blocks run kernel #8; with ``--memory-attention-heads 2`` memory
attention runs two heads, whose cross-attention takes kernel #7), warms it up on a video of the same length,
then runs under
``torch.profiler`` three windows of one synthetic 480x854 video:
``encode`` (init_state: resize + trunk + neck), ``prompt`` (8 point
prompts on frame 0 + the conditioning step) and ``propagate`` (the tracked
frames), at 8 frames and 8 objects. For each window it prints the wall
time, the summed device (kernel) time, the device busy share, the kernels
that take the most device time and the host operations that take the most
CPU time.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import prompt_all, synthetic_params, synthetic_video
from .eval.predictor import VideoPredictor
from .models import sam2 as sam2_mod


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


FRAMES, OBJECTS, SEED, TOP = 8, 8, 0, 8


def report(prof, label: str, wall_s: float, top: int = TOP):
    """Device time counts only device-side events (kernels, copies), so
    an operator and the kernels it launched are not counted twice."""
    avgs = prof.key_averages()
    events = [e for e in avgs if _device_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=_device_us, reverse=True)
    dev_us = sum(_device_us(e) for e in events)
    print(f"[{label}] wall {wall_s * 1e3:.3f} ms, device {dev_us / 1e3:.3f} "
          f"ms, busy {dev_us / 1e6 / wall_s:.3f}", flush=True)
    for e in events[:top]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}", flush=True)
    host = sorted((e for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host ops by self CPU time:", flush=True)
    for e in host[:top // 2]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused-twoway", action="store_true")
    ap.add_argument("--memory-attention-heads", type=int, default=1)
    args = ap.parse_args()
    fused, heads = args.fused_twoway, args.memory_attention_heads
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = sam2_mod.SAM2Config(image_size=384, compute_dtype="bfloat16",
                              fused_twoway=fused,
                              memory_attention_num_heads=heads)
    pred = VideoPredictor(synthetic_params(cfg, SEED), cfg,
                          max_objects=OBJECTS, device="cuda")
    # warm up at the profiled length: new batch shapes pay one-time costs
    warm, wc = synthetic_video(SEED + 1, FRAMES, objects=OBJECTS)
    state = pred.init_state(warm)
    prompt_all(pred, state, wc)
    list(pred.propagate_in_video(state))

    video, centres = synthetic_video(SEED, FRAMES, objects=OBJECTS)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    state = None

    def encode():
        nonlocal state
        state = pred.init_state(video)

    def prompt():
        prompt_all(pred, state, centres)
        pred._ensure_cond_outputs(state)

    def propagate():
        list(pred.propagate_in_video(state))

    for label, fn in (("encode", encode), ("prompt", prompt),
                      (f"propagate fused_twoway={fused} "
                       f"memory_attention_heads={heads}", propagate)):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(prof, label, wall)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
