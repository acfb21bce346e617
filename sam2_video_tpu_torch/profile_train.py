"""Where the headline train step's device time goes, on one NVIDIA GPU.

    python3 -m sam2_video_tpu_torch.profile_train [--trainable mem|all]
        [--fused-twoway]

Builds the train step of ``bench.py``'s headline configuration in the port
(SAM2-tiny 384 px, bf16, T=10, O=8, C=7, B=2, point prompts, AdamW lr
1e-4; ``synthetic_params`` weights, the example clip) with trainable
memory attention and memory encoder (``mem``, the default) or every
module but the pointer projections (``all``: the reference's
mem+md+pe+ie, whose trunk runs kernel #6 backward); with
``--fused-twoway`` the decoder's two-way blocks run kernel #8 forward and
backward. Runs one warm-up step, then one step under ``torch.profiler``.
Prints the step's wall time, the summed device (kernel) time, the device
busy share, the kernels that take the most device time and the host
operations that take the most CPU time (``profile_serving``'s report).
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import example_clip, synthetic_params
from .models import sam2 as sam2_mod
from .models.video_model import VideoModelConfig
from .profile_serving import report
from .training.loop import TrainState, make_train_step
from .training.losses import LossConfig
from .training.optimizer import make_optimizer

T, O, C, B, SEED = 10, 8, 7, 2, 0
TRAINABLE = {"mem": ["memory_attention", "memory_encoder"],
             "all": ["memory_attention", "memory_encoder", "mask_decoder",
                     "prompt_encoder", "image_encoder"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainable", choices=sorted(TRAINABLE), default="mem")
    ap.add_argument("--fused-twoway", action="store_true")
    args = ap.parse_args()
    trainable = TRAINABLE[args.trainable]
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = sam2_mod.SAM2Config(image_size=384, compute_dtype="bfloat16",
                              use_flash_attention=True,
                              use_activation_checkpoint=False,
                              fused_twoway=args.fused_twoway)
    params = synthetic_params(cfg, SEED).to("cuda")
    tx = make_optimizer(params, {"lr": 1e-4, "type": "AdamW"},
                        {"enabled": False}, total_steps=1000,
                        trainable_modules=trainable)
    step = make_train_step(VideoModelConfig(sam2=cfg), LossConfig(), tx,
                           trainable_modules=trainable, device="cuda")
    state = TrainState.create(params, tx)
    batch = example_clip(cfg.image_size, T=T, O=O, C=C, B=B).to("cuda")
    state, _ = step(state, batch)                  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, f"train step B={B} T={T} O={O} trainable "
           f"{'+'.join(trainable)} fused_twoway={args.fused_twoway}", wall,
           top=16)
    print(f"loss {float(metrics['total_loss']):.6g}", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
