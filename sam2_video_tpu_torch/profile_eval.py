"""Where the evaluation path's time goes, on one NVIDIA GPU. Run from the
repository root:

    python3 -m sam2_video_tpu_torch.profile_eval [--probs] [--host]
        [--batch-videos G] [--clip-length L]

Writes the fit phase's dataset of ``chip_smoke.py`` (2 synthetic videos of
20 PNG frames at 480x854, 7 categories) under ``outputs/profile_eval/``
and runs ``eval/inference.py inference`` and ``evaluate`` over it with
``synthetic_params`` weights (config.yaml's eval: point prompts, the
whole video one clip, or clips of ``--clip-length`` frames, reverse then
forward; ``--batch-videos G`` tracks G clips of one shape in lockstep,
``eval.batch_videos``): once to warm up, then once
under ``torch.profiler`` (``profile_serving``'s report: wall, device
time, busy share, the kernels and host operations that take the most
time) or, with ``--host``, under ``cProfile`` (the host functions that
take the most time of their own). ``--probs`` also writes the float16
probability maps (``eval.probs_out_dir``, off in config.yaml). Prints the
frames propagated and frames/s, then removes its outputs.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import make_synthetic_dataset, synthetic_params
from .eval.inference import inference
from .eval.metrics import evaluate
from .models import sam2 as sam2_mod
from .profile_fit import CATS, FRAMES, HW, SEED, VIDEOS
from .profile_serving import report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probs", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--batch-videos", type=int, default=1)
    ap.add_argument("--clip-length", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    work = Path.cwd() / "outputs" / "profile_eval"
    shutil.rmtree(work, ignore_errors=True)
    data = make_synthetic_dataset(work / "ds", num_videos=VIDEOS,
                                  frames_per_video=FRAMES, image_hw=HW,
                                  num_categories=CATS, seed=SEED,
                                  png_filters=np.arange(HW[0]) % 5)
    cfg = sam2_mod.SAM2Config(image_size=384, use_activation_checkpoint=False)
    params = synthetic_params(cfg, SEED)
    kw = dict(max_objects=8, probs_out_dir="probs" if args.probs else None,
              batch_videos=args.batch_videos, clip_length=args.clip_length,
              device="cuda")

    def run(name):
        pred, _ = inference(params, cfg, data, work / name, **kw)
        evaluate(pred, data, work / name / "eval")

    run("warmup")
    torch.cuda.synchronize()
    # each clip prompted on its first frame: that frame in reverse, then
    # forward
    clip = args.clip_length or FRAMES
    n = VIDEOS * (FRAMES + -(-FRAMES // clip))
    label = (f"eval inference() + evaluate, {VIDEOS} videos x {FRAMES} "
             f"frames of {HW[0]}x{HW[1]} in clips of {clip}, "
             f"batch_videos={args.batch_videos}, 8 objects max, probability "
             f"maps {'on' if args.probs else 'off'}")
    if args.host:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run("profiled")
        torch.cuda.synchronize()
        prof.disable()
        wall = time.perf_counter() - t0
        print(f"[{label}] wall {wall * 1e3:.3f} ms under cProfile", flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(16)
    else:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run("profiled")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(prof, label, wall, top=12)
    print(f"{n} frames propagated, {n / wall:.2f} frames/s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
