"""One rank of the port's data-parallel train step on the CPU, for
``tests/test_torch_port_ddp.py``.

    python -m tests._ddp_worker <weights.npz> <out.pt>

with torchrun's variables (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) in the environment. The rank initialises gloo through
``parallel/dist.py maybe_initialize_distributed``, loads its shard of each
global batch (``ClipLoader(process_index=rank, process_count=world)`` over
``tests/_mp_common.py``'s index-deterministic clips), runs the train step
with the process group for ``STEPS`` steps, averages each step's metrics
over the ranks as ``fit`` does where it logs, and saves the losses and its
final trainable parameters. Imports torch and the port only.
"""

from __future__ import annotations

import sys

TRAINABLE = ["memory_attention"]
GLOBAL_BATCH = 4
LR = 3e-5        # 3 Adam steps move a leaf at most ~9e-5
KW = dict(image_size=64, compute_dtype="float32",
          use_activation_checkpoint=False)


def run_steps(params, loader, steps: int, group=None) -> tuple[list, dict]:
    """``steps`` train steps of the port (``group``: averaged over its
    ranks); returns the losses (averaged over the ranks) and the final
    trainable parameters."""
    from sam2_video_tpu_torch.models.sam2 import SAM2Config
    from sam2_video_tpu_torch.models.video_model import VideoModelConfig
    from sam2_video_tpu_torch.parallel import dist
    from sam2_video_tpu_torch.training.loop import TrainState, make_train_step
    from sam2_video_tpu_torch.training.losses import LossConfig
    from sam2_video_tpu_torch.training.optimizer import make_optimizer

    tx = make_optimizer(params, {"lr": LR, "type": "AdamW"},
                        {"enabled": False}, total_steps=steps,
                        trainable_modules=TRAINABLE)
    step = make_train_step(VideoModelConfig(sam2=SAM2Config(**KW)),
                           LossConfig(), tx, trainable_modules=TRAINABLE,
                           device="cpu", group=group)
    state = TrainState.create(params, tx)
    losses = []
    for _, batch in zip(range(steps), loader):
        state, metrics = step(state, batch)
        if group is not None:
            metrics = dist.all_reduce_mean(metrics, group)
        losses.append(float(metrics["total_loss"]))
    return losses, {n: t.detach().clone() for n, t in
                    state.params.named_parameters()
                    if n.split(".")[0] in TRAINABLE}


def make_loader(batch_size: int, process_index: int, process_count: int):
    from sam2_video_tpu_torch.data.pipeline import ClipLoader
    from tests._mp_common import SEED, DeterministicClipDataset

    return ClipLoader(DeterministicClipDataset(), batch_size=batch_size,
                      shuffle=True, seed=SEED, num_workers=1,
                      process_index=process_index,
                      process_count=process_count)


def main(npz: str, out: str) -> None:
    import torch
    import torch.distributed as tdist

    from sam2_video_tpu_torch.convert import to_param_tree
    from sam2_video_tpu_torch.parallel import dist
    from sam2_video_tpu_torch.training.checkpoint import load_params_npz
    from tests._mp_common import STEPS

    torch.set_num_threads(1)
    assert dist.maybe_initialize_distributed({}, "cpu")
    try:
        world, rank = dist.world_size(), dist.rank()
        params = to_param_tree(load_params_npz(npz))
        dist.broadcast_params(dict(params.named_parameters()))
        losses, trained = run_steps(
            params, make_loader(GLOBAL_BATCH // world, rank, world), STEPS,
            group=tdist.group.WORLD)
        torch.save({"rank": rank, "world": world, "backend":
                    tdist.get_backend(), "losses": losses,
                    "params": trained}, out)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:])
