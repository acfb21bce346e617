"""Data-parallel dry run (counterpart of ``__graft_entry__.py``
``dryrun_multichip``): N ranks on this host train SAM2-tiny at 64 px in
bf16, memory attention and memory encoder trainable, for 2 optimizer steps
with the gradients averaged over the ranks, each rank on its own clip of
one batch; asserts that the loss falls and that the ranks end with the
same parameters.

    python -m sam2_video_tpu_torch.parallel.dryrun [--ranks 2] [--device cpu]

On the card (the default) each rank takes a card of its own under NCCL,
or, with fewer cards than ranks, all share ``cuda:0`` under gloo.
"""

from __future__ import annotations

import argparse
import sys

import torch

TRAINABLE = ["memory_attention", "memory_encoder"]
STEPS = 2


def _rank(rank: int, world: int, port: int, device_type: str) -> None:
    import os

    import torch.distributed as tdist

    from ..data.synthetic import example_clip
    from ..data.types import FIELDS, VideoClipBatch
    from ..models import sam2 as sam2_mod
    from ..models.video_model import VideoModelConfig
    from ..training.loop import TrainState, make_train_step
    from ..training.losses import LossConfig
    from ..training.optimizer import make_optimizer
    from . import dist

    os.environ.update(dist.rank_env(rank, world, port))
    dist.maybe_initialize_distributed({"enabled": True}, device_type)
    try:
        device = dist.rank_device(device_type)
        cfg = sam2_mod.SAM2Config(backbone="tiny", image_size=64,
                                  compute_dtype="bfloat16",
                                  use_activation_checkpoint=False)
        params = sam2_mod.init(cfg, seed=0).to(device)
        dist.broadcast_params(dict(params.named_parameters()))
        tx = make_optimizer(params, {"lr": 1e-3, "type": "AdamW"},
                            {"enabled": False}, total_steps=10,
                            trainable_modules=TRAINABLE)
        step = make_train_step(VideoModelConfig(sam2=cfg, prompt_type="point"),
                               LossConfig(), tx, trainable_modules=TRAINABLE,
                               device=device, group=tdist.group.WORLD)
        batch = example_clip(cfg.image_size, T=2, O=2, C=3, B=world)
        mine = VideoClipBatch(**{f: getattr(batch, f)[rank:rank + 1]
                                 for f in FIELDS})
        state = TrainState.create(params, tx)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, mine)
            losses.append(float(dist.all_reduce_mean(
                {"loss": metrics["total_loss"]})["loss"]))
        flat = torch.cat([t.reshape(-1) for n, t in
                          state.params.named_parameters()
                          if n.split(".")[0] in TRAINABLE])
        first = flat.clone()
        tdist.broadcast(first, src=0)
        if not torch.equal(flat, first):
            raise RuntimeError(f"rank {rank}: parameters differ from rank 0's")
        if not losses[1] < losses[0]:
            raise RuntimeError(f"optimizer made no progress across {world} "
                               f"ranks: {losses}")
        if dist.is_main():
            print(f"dryrun({world} ranks, {tdist.get_backend()}, {device}): "
                  f"losses={[round(x, 4) for x in losses]} (decreasing), "
                  "ranks' parameters equal OK", flush=True)
    finally:
        dist.destroy()


def dryrun(ranks: int = 2, device_type: str = "cuda") -> None:
    """Start ``ranks`` processes (spawn) and run the dry run in each; raises
    if any rank fails."""
    import torch.multiprocessing as mp

    from . import dist

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    if device_type == "cuda":
        from ..ops import kernel_build

        kernel_build.build()
    mp.spawn(_rank, nprocs=ranks, join=True,
             args=(ranks, dist.free_port(), device_type))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
