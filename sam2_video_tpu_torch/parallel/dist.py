"""Data parallelism on ``torch.distributed`` (counterpart of
``sam2_video_tpu/parallel/mesh.py``).

The JAX package shards the clip batch over a ``data`` mesh axis and lets
XLA insert the gradient all-reduce. Here each rank is a process that
loads its own shard of the global batch (``ClipLoader(process_index=rank,
process_count=world)``), runs the train step on it, and averages the
trainable gradients with the other ranks before the optimizer update
(``training/loop.py``). Parameters start equal on every rank (a broadcast
from rank 0) and stay equal, since every rank applies the same averaged
gradients.

A rank's device is ``cuda:LOCAL_RANK`` when every local rank has a card of
its own, else ``cuda:0`` for every rank (several ranks sharing one card).
The backend follows: NCCL when each rank has its own card; gloo on the CPU
and when ranks share a card (NCCL refuses two ranks on one GPU, gloo
reduces CUDA tensors by staging them through the host).
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

# Every collective, the barrier after the post-fit eval included, waits at
# most this long. Rank 0 evaluates alone after the fit while the other ranks
# wait at that barrier, so the limit covers a whole eval of a validation set
# (thousands of frames at a few frames/s).
TIMEOUT = datetime.timedelta(hours=4)


def env_launched() -> bool:
    """Whether this process is a rank that torchrun (or ``rank_env``)
    started: ``WORLD_SIZE`` and ``RANK`` are set."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_layout() -> tuple[int, int]:
    """(local rank, ranks on this host) from torchrun's variables; one
    rank per host when they are absent."""
    return (int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def shares_card(device_type: str) -> bool:
    """Whether the local ranks outnumber the cards, so that they share
    one."""
    return (device_type == "cuda"
            and local_layout()[1] > torch.cuda.device_count())


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when each local rank has a
    card, ``cuda:0`` when they share, the CPU for ``device_type`` cpu."""
    if device_type != "cuda":
        return torch.device(device_type)
    if shares_card(device_type):
        return torch.device("cuda", 0)
    return torch.device("cuda", local_layout()[0])


def backend_for(device_type: str) -> str:
    return ("nccl" if device_type == "cuda" and not shares_card(device_type)
            else "gloo")


def maybe_initialize_distributed(dist_cfg=None,
                                 device_type: str = "cuda") -> bool:
    """``init_process_group`` behind a flag (the JAX package's
    ``maybe_initialize_distributed``; the reference trains with Lightning
    DDP).

    Enabled by ``trainer.distributed.enabled`` or by torchrun's environment
    (``WORLD_SIZE`` and ``RANK``). With ``coordinator_address``
    (``host:port``) the process group meets there and ``num_processes`` and
    ``process_id`` (config keys, else ``WORLD_SIZE`` / ``RANK``) are
    required; without it torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` are.
    An enabled run that cannot initialise raises. Returns whether
    distributed mode is active. Idempotent: a second call returns True."""
    if dist.is_initialized():
        return True
    dist_cfg = dict(dist_cfg or {})
    if not (bool(dist_cfg.get("enabled", False)) or env_launched()):
        return False
    addr = dist_cfg.get("coordinator_address")
    nproc = dist_cfg.get("num_processes") or os.environ.get("WORLD_SIZE")
    pid = dist_cfg.get("process_id")
    if pid is None:
        pid = os.environ.get("RANK")
    if addr:
        if nproc is None or pid is None:
            raise ValueError(
                "distributed init with an explicit coordinator_address also "
                "needs num_processes and process_id (config keys or "
                "WORLD_SIZE / RANK)")
        init_method = f"tcp://{addr}"
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if nproc is None or pid is None or missing:
            raise ValueError(
                "trainer.distributed.enabled needs torchrun's environment "
                "(WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) or "
                "trainer.distributed.coordinator_address with num_processes "
                "and process_id")
        init_method = "env://"
    device = rank_device(device_type)
    backend = backend_for(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # NCCL binds the group to the rank's card (its barrier would otherwise
    # guess the card from the rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(nproc), rank=int(pid),
                            timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def all_reduce_mean(tensors: dict, group=None) -> dict:
    """The mean over the ranks of ``group`` of each tensor of a dict, in one
    flattened bucket (one collective). Returns views of the bucket, in the
    tensors' own shapes and dtypes; the inputs are left as they were."""
    if not tensors:
        return {}
    names = list(tensors)
    flat = torch.cat([tensors[n].detach().reshape(-1).float()
                      for n in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    out, offset = {}, 0
    for n in names:
        t = tensors[n]
        out[n] = flat[offset:offset + t.numel()].view(t.shape).to(t.dtype)
        offset += t.numel()
    return out


def broadcast_params(named: dict, src: int = 0, group=None) -> None:
    """Copy rank ``src``'s tensors into every rank's, in place, in one
    flattened bucket."""
    if not named:
        return
    tensors = list(named.values())
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank_: int, world: int, port: int) -> dict:
    """torchrun's variables for rank ``rank_`` of ``world`` ranks on this
    host, meeting at ``localhost:port``."""
    return {"WORLD_SIZE": str(world), "RANK": str(rank_),
            "LOCAL_RANK": str(rank_), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def card_env(worker: int) -> dict:
    """``CUDA_VISIBLE_DEVICES`` of worker slot ``worker`` of a tool that runs
    one process per slot (``sweep_torch.py``,
    ``multi_baseline_eval_torch.py``): one card each, slot i on card i mod
    (number of cards), as the reference pins one GPU per worker; nothing on
    a host without cards. The cards are those this process sees: where its
    own ``CUDA_VISIBLE_DEVICES`` names some, slot i gets the (i mod n)-th of
    them."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        return {}
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in visible.split(",")][:n] if visible
             else [str(i) for i in range(n)])
    return {"CUDA_VISIBLE_DEVICES": cards[worker % n]}
