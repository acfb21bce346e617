"""Train and eval steps (counterpart of ``sam2_video_tpu/training/loop.py``).

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the forward of every clip of the batch (the JAX package maps the per-clip
forward with ``jax.vmap``; here the clips run one after another and the
losses are averaged), the loss, the backward with respect to the
trainable partition only, and the optimizer update, in place.

Freezing follows the JAX package's ``make_train_step``: only the leaves of
the trainable top-level entries get ``requires_grad``, so autograd never
builds the frozen modules' backward; a frozen image encoder runs the
forward-only trunk kernel, a trainable one (``fused_backbone_vjp``) the
trainable block, kernel #1 forward and kernel #6 backward.

Derived entries (``models/sam2.py`` ``derive``): the frozen modules' are
made once, on the first step; the trainable modules' are made from the
current parameters in every step (the memory encoder's packed kernel
operands, the compute-dtype casts under autograd), and memory attention's
permuted projections inside ``forward_train``.

``fit`` is the epoch loop: per-epoch training and validation, metric
logging, best-validation tracking and checkpoints after each validation.

Data parallelism (``parallel/dist.py``): given a process group, the train
step averages the trainable gradients over the ranks in one flattened
bucket before the optimizer update, so the clip by global norm and the
``grad_norm`` metric see the global gradient, as the JAX package's
sharded-autodiff mean gives it. The model is not wrapped in
``DistributedDataParallel``: its reducer hooks the leaves' ``AccumulateGrad``
nodes, which the step's ``torch.autograd.grad`` never reaches. The eval
step averages each batch's metrics over the ranks, and ``fit`` averages
the training metrics where it logs them, on every rank at the same steps,
so the loop adds no synchronisation per step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..data.types import VideoClipBatch
from ..models import sam2 as sam2_mod
from ..models.video_model import VideoModelConfig, forward_train
from ..ops import common as nn
from ..parallel import dist as dist_mod
from .losses import CORE_LOSS_KEY, LossConfig, compute_loss
from .optimizer import apply_updates, top_level_label


@dataclasses.dataclass
class TrainState:
    params: nn.ParamTree
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, params: nn.ParamTree, tx) -> "TrainState":
        return cls(params=params, opt_state=tx.init(dict(
            params.named_parameters())), step=0)


def batched_loss_fn(mcfg: VideoModelConfig, lcfg: LossConfig,
                    training: bool = True) -> Callable:
    """(params, VideoClipBatch) -> (scalar loss, dict of scalar metrics):
    each loss averaged over the clips of the batch."""

    def loss_fn(params, batch: VideoClipBatch):
        per_clip = []
        for i in range(batch.batch_size):
            clip = batch.clip(i)
            _, per_cat = forward_train(params, mcfg, clip, training=training)
            per_clip.append(compute_loss(lcfg, per_cat, clip.cat_masks))
        losses = {k: torch.stack([c[k] for c in per_clip]).mean()
                  for k in per_clip[0]}
        return losses[CORE_LOSS_KEY], losses

    return loss_fn


def make_train_step(mcfg: VideoModelConfig, lcfg: LossConfig, tx,
                    trainable_modules=None,
                    device: str | torch.device = "cuda",
                    group=None) -> Callable:
    """``trainable_modules`` names MODULE_MAPPING entries (bare top-level
    parameters always train); None trains everything. The state's
    parameters must already be on ``device``; the batch is moved there.
    With a process ``group`` the gradients are averaged over its ranks
    before the update; the returned metrics are this rank's."""
    dev = torch.device(device)
    frozen_encoder = (trainable_modules is not None
                      and "image_encoder" not in trainable_modules)
    mcfg = dataclasses.replace(mcfg, sam2=dataclasses.replace(
        mcfg.sam2, fused_backbone_vjp=not frozen_encoder))
    cfg = mcfg.sam2
    modules = () if trainable_modules is None else tuple(trainable_modules)
    loss_fn = batched_loss_fn(mcfg, lcfg, training=True)
    frozen_cache: dict = {}

    def trains(top: str) -> bool:
        return trainable_modules is None or \
            top_level_label(top, modules) == "train"

    def step_fn(state: TrainState, batch: VideoClipBatch):
        params = state.params
        named = dict(params.named_parameters())
        train_names = [n for n in named if trains(n.split(".")[0])]
        for n, t in named.items():
            t.requires_grad_(n in set(train_names))
        tops = [k for k in params.tree() if not k.startswith("_")]
        frozen_tops = [k for k in tops if not trains(k)]
        if frozen_cache.get("params") is not params:
            frozen_cache.clear()
            frozen_cache["params"] = params
            frozen_cache["tree"] = sam2_mod.derive(params.tree(), cfg,
                                                   modules=frozen_tops)
        tree = params.tree()
        for k in frozen_tops:
            tree[k] = frozen_cache["tree"][k]
        sam2_mod.derive(tree, cfg, modules=[k for k in tops if trains(k)])

        loss, metrics = loss_fn(tree, batch.to(dev))
        leaves = [named[n] for n in train_names]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(t))
                 for n, t, g in zip(train_names, leaves, grads)}
        for t in leaves:
            t.requires_grad_(False)
        if group is not None:
            grads = dist_mod.all_reduce_mean(grads, group)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, named)
            apply_updates(named, updates)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = torch.sqrt(sum(
                (g.float() ** 2).sum() for g in grads.values()))
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics, grads

    def step(state: TrainState, batch: VideoClipBatch):
        new_state, metrics, _ = step_fn(state, batch)
        return new_state, metrics

    step.with_grads = step_fn
    return step


def make_eval_step(mcfg: VideoModelConfig, lcfg: LossConfig,
                   device: str | torch.device = "cuda",
                   group=None) -> Callable:
    """(params, batch) -> dict of scalar metrics, without gradient; with a
    process ``group``, averaged over its ranks."""
    dev = torch.device(device)
    loss_fn = batched_loss_fn(mcfg, lcfg, training=False)

    @torch.no_grad()
    def step(params: nn.ParamTree, batch: VideoClipBatch):
        _, metrics = loss_fn(sam2_mod.prepare(params, mcfg.sam2),
                             batch.to(dev))
        if group is not None:
            metrics = dist_mod.all_reduce_mean(metrics, group)
        return metrics

    return step


# ---------------------------------------------------------------------------
# The epoch loop (host orchestration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: list
    best_val: float


def fit(state: TrainState, train_step, eval_step, train_loader, val_loader,
        max_epochs: int, limit_train_batches: int | None = None,
        limit_val_batches: int | None = None, log_every: int = 20,
        logger=None, checkpointer=None, val_check_interval: float = 1.0,
        step_timer: list | None = None, wait_timer: list | None = None,
        viz_fn=None, viz_every_n_steps: int = 0, start_epoch: int = 0,
        group=None) -> FitResult:
    """Per-epoch training and validation (the JAX package's ``fit``):
    training metrics every ``log_every`` steps, validation at the end of
    each epoch or every ``val_check_interval`` of it, a checkpoint after
    each validation monitored on val/total_loss, ``viz_fn(params, batch,
    step)`` every ``viz_every_n_steps`` steps (the training GIFs), and
    epochs from ``start_epoch``. The loss is read on the host only where a
    step is logged or timed (``step_timer`` gets each step's seconds, the
    wait for its loss included), so the loop adds no synchronisation per
    step. ``wait_timer`` gets the seconds each training batch was waited
    for, from the request to the train loader until it yielded. With a
    process ``group`` the logged training metrics are averaged over its
    ranks (every rank must call ``fit`` with the same loaders' lengths and
    limits, so that all take part in the same collectives); ``logger`` and
    ``checkpointer`` are rank 0's alone."""
    history = []
    best_val = float("inf")

    def log(split, step, metrics):
        rec = {"split": split, "step": int(step),
               **{k: float(v) for k, v in metrics.items()}}
        history.append(rec)
        if logger is not None:
            logger.log(rec)

    def run_val(epoch):
        nonlocal best_val
        if val_loader is None:
            return
        agg, n = {}, 0
        for bi, batch in enumerate(val_loader):
            if limit_val_batches is not None and bi >= limit_val_batches:
                break
            m = eval_step(state.params, batch)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return
        m = {f"val/{k}": v / n for k, v in agg.items()}
        log("val", state.step, m)
        vloss = m.get(f"val/{CORE_LOSS_KEY}", float("inf"))
        if checkpointer is not None:
            checkpointer.save(state, metric=vloss, epoch=epoch)
        best_val = min(best_val, vloss)

    for epoch in range(start_epoch, max_epochs):
        nb = len(train_loader)
        if limit_train_batches is not None:
            nb = min(nb, limit_train_batches)
        val_every = (max(1, int(nb * val_check_interval))
                     if val_check_interval and val_check_interval < 1.0
                     else None)
        t_ask = time.perf_counter()
        for bi, batch in enumerate(train_loader):
            if limit_train_batches is not None and bi >= limit_train_batches:
                break
            t0 = time.perf_counter()
            if wait_timer is not None:
                wait_timer.append(t0 - t_ask)
            state, metrics = train_step(state, batch)
            if step_timer is not None:
                float(metrics[CORE_LOSS_KEY])
                step_timer.append(time.perf_counter() - t0)
            if state.step % max(log_every, 1) == 0:
                if group is not None:
                    metrics = dist_mod.all_reduce_mean(metrics, group)
                log("train", state.step,
                    {f"train/{k}": v for k, v in metrics.items()})
            if (viz_fn is not None and viz_every_n_steps > 0
                    and state.step % viz_every_n_steps == 0):
                viz_fn(state.params, batch, state.step)
            if val_every and (bi + 1) % val_every == 0:
                run_val(epoch)
            t_ask = time.perf_counter()
        if not val_every:
            run_val(epoch)
    return FitResult(state=state, history=history, best_val=best_val)
