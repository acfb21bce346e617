"""Where the fit loop's time goes, on one NVIDIA GPU. Run from the
repository root:

    python3 -m sam2_video_tpu_torch.profile_fit [--epochs 1] [--batches 2]

Writes the fit phase's dataset of ``chip_smoke.py`` (2 synthetic videos of
20 PNG frames at 480x854, 7 categories) and an npz of ``synthetic_params``
under ``outputs/profile_fit/``, runs ``train_torch.py`` once to warm up
(one train batch), then again with ``fit`` under ``torch.profiler``: the
headline configuration (config.yaml at 384 px, bf16, T=10, B=2, 8
objects, trainable memory attention and memory encoder), ``--epochs`` of
``--batches`` train batches and one validation batch with its
checkpoints. Prints the fit's wall time, the summed device (kernel) time,
the device busy share, the kernels that take the most device time and the
host operations that take the most CPU time (``profile_serving``'s
report), with each train step's seconds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import make_synthetic_dataset, synthetic_params
from .models import sam2 as sam2_mod
from .profile_serving import report
from .training import checkpoint, loop

SEED, VIDEOS, FRAMES, HW, CATS = 0, 2, 20, (480, 854), 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import train_torch

    home = Path.cwd()
    work = home / "outputs" / "profile_fit"
    shutil.rmtree(work, ignore_errors=True)
    data = make_synthetic_dataset(work / "ds", num_videos=VIDEOS,
                                  frames_per_video=FRAMES, image_hw=HW,
                                  num_categories=CATS, seed=SEED)
    cfg = sam2_mod.SAM2Config(image_size=384, use_activation_checkpoint=False)
    checkpoint.save_params_npz(synthetic_params(cfg, SEED),
                               work / "weights.npz")
    common = [f"data.train_path={data}", f"data.val_path={data}",
              "data.image_size=384", "data.video_clip_length=10",
              "data.stride=10", "data.batch_size=2",
              f"data.num_categories={CATS}", "model.max_objects=8",
              f"model.checkpoint_path={work / 'weights.npz'}",
              "eval.enabled=false", "visualization.enabled=false",
              "trainer.log_every_n_steps=1", "device=cuda"]
    plain_fit = loop.fit
    timing = {}

    def profiled_fit(*a, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = plain_fit(*a, **kw)
            torch.cuda.synchronize()
            timing["wall"] = time.perf_counter() - t0
        timing["prof"] = prof
        return out

    for name, extra in (("warmup", ["trainer.max_epochs=1",
                                    "trainer.limit_train_batches=1",
                                    "trainer.limit_val_batches=0"]),
                        ("profiled", [f"trainer.max_epochs={args.epochs}",
                                      "trainer.limit_train_batches="
                                      f"{args.batches}",
                                      "trainer.limit_val_batches=1"])):
        (work / name).mkdir()
        os.chdir(work / name)
        steps = []
        try:
            if name == "profiled":
                loop.fit = profiled_fit
            train_torch.run(common + extra, step_timer=steps)
        finally:
            loop.fit = plain_fit
            os.chdir(home)
    report(timing["prof"], f"fit {args.epochs} epoch(s) x {args.batches} "
           "train batches + 1 validation batch each, B=2 T=10 O=8 384px",
           timing["wall"], top=16)
    print("train step s: " + ", ".join(f"{t:.3f}" for t in steps)
          + f"; clips/s over the fit {2 * len(steps) / timing['wall']:.3f}",
          flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
