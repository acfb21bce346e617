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

The epoch loop, checkpoints and data parallelism are not ported yet
(ROADMAP.md, queue 1, items 6 and 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..data.types import VideoClipBatch
from ..models import sam2 as sam2_mod
from ..models.video_model import VideoModelConfig, forward_train
from ..ops import common as nn
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
                    device: str | torch.device = "cuda") -> Callable:
    """``trainable_modules`` names MODULE_MAPPING entries (bare top-level
    parameters always train); None trains everything. The state's
    parameters must already be on ``device``; the batch is moved there."""
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
                   device: str | torch.device = "cuda") -> Callable:
    """(params, batch) -> dict of scalar metrics, without gradient."""
    dev = torch.device(device)
    loss_fn = batched_loss_fn(mcfg, lcfg, training=False)

    @torch.no_grad()
    def step(params: nn.ParamTree, batch: VideoClipBatch):
        _, metrics = loss_fn(sam2_mod.prepare(params, mcfg.sam2),
                             batch.to(dev))
        return metrics

    return step
