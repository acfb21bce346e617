"""Optimizer, schedule and module freezing (counterpart of
``sam2_video_tpu/training/optimizer.py``), written as plain tensor code
that repeats the arithmetic of the optax chain the JAX package builds:

    MultiSteps(k)(multi_transform({
        "train":  clip_by_global_norm -> Adam(W) or AMSGrad -> decay -> -lr,
        "freeze": set_to_zero}))

``torch.optim`` does not stand in for it: it skips a parameter whose
``.grad`` is None, while optax updates every "train" leaf, so a trainable
module that gets a zero gradient (the memory encoder behind the detached
bank) still decays under AdamW. Every trainable leaf here has a gradient
tensor (zeros where autograd gave none).

Freezing labels each top-level entry by ``MODULE_MAPPING``; bare top-level
parameters (maskmem_tpos_enc, no_mem_embed, no_obj_ptr, mask_downsample,
...) are not mapped and stay trainable, as in the reference.

Parameters, gradients and updates are flat dicts keyed by the parameter
names (``ParamTree.named_parameters``). ``apply_updates`` changes the
parameters in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from ..models.sam2 import MODULE_MAPPING


def cosine_schedule_with_warmup(peak_lr: float, warmup_steps: int,
                                total_steps: int, num_cycles: float = 0.5):
    """transformers' get_cosine_schedule_with_warmup, in float32 as the JAX
    package computes it."""
    warmup_steps = max(int(warmup_steps), 0)
    total_steps = max(int(total_steps), 1)
    f32 = torch.float32

    def schedule(step: int) -> torch.Tensor:
        s = torch.tensor(float(step), dtype=f32)
        warm = s / max(warmup_steps, 1)
        progress = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        angle = torch.tensor(math.pi * num_cycles * 2.0, dtype=f32) * progress
        cos_factor = torch.clamp(0.5 * (1.0 + torch.cos(angle)), min=0.0)
        return peak_lr * (warm if step < warmup_steps else cos_factor)

    return schedule


def top_level_label(top_key: str, trainable_modules: Sequence[str]) -> str:
    mapped = {v[0]: k for k, v in MODULE_MAPPING.items()}
    if top_key in mapped:
        return "train" if mapped[top_key] in trainable_modules else "freeze"
    return "train"


def partition_params(params: dict, trainable_modules: Sequence[str]):
    """Split a flat name -> tensor dict into (trainable, frozen)."""
    train = {k: v for k, v in params.items()
             if top_level_label(k.split(".")[0], trainable_modules) == "train"}
    frozen = {k: v for k, v in params.items() if k not in train}
    return train, frozen


@dataclasses.dataclass
class OptState:
    count: int                  # inner (Adam) step count
    mu: dict
    nu: dict
    nu_max: dict | None         # AMSGrad's running maximum of nu
    mini_step: int = 0          # MultiSteps
    gradient_step: int = 0
    acc_grads: dict | None = None


@dataclasses.dataclass
class Optimizer:
    train: Callable[[str], bool]     # name -> trainable
    schedule: Callable[[int], torch.Tensor] | float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    amsgrad: bool
    adamw: bool
    clip: float
    every_k: int = 1

    def init(self, params: dict) -> OptState:
        z = {k: torch.zeros_like(v) for k, v in params.items()
             if self.train(k)}
        return OptState(
            count=0, mu=z, nu={k: torch.zeros_like(v) for k, v in z.items()},
            nu_max=({k: torch.zeros_like(v) for k, v in z.items()}
                    if self.amsgrad else None),
            acc_grads=({k: torch.zeros_like(v) for k, v in params.items()}
                       if self.every_k > 1 else None))

    def _lr(self, count: int):
        return (self.schedule(count) if callable(self.schedule)
                else self.schedule)

    def _inner(self, grads: dict, state: OptState, params: dict):
        """One update of the "train" transform; frozen leaves get zeros."""
        names = [k for k in params if self.train(k)]
        g = {k: grads[k].float() for k in names}
        norm = torch.sqrt(sum((g[k] * g[k]).sum() for k in names))
        if not bool(norm < self.clip):
            g = {k: (v / norm) * self.clip for k, v in g.items()}
        b1, b2, count = self.b1, self.b2, state.count + 1
        mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in names}
        nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * state.nu[k] for k in names}
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** count
        nu_max = None
        if self.amsgrad:
            nu_max = {k: torch.maximum(state.nu_max[k], nu[k])
                      for k in names}
            second = nu_max
        else:
            second = nu
        lr = self._lr(state.count)
        updates = {}
        for k in names:
            u = (mu[k] / bc1.to(mu[k].device)) / (
                torch.sqrt(second[k] / bc2.to(mu[k].device)) + self.eps)
            if self.adamw:
                u = u + self.weight_decay * params[k]
            u = -lr * u if not torch.is_tensor(lr) else -lr.to(u.device) * u
            if not self.adamw and self.weight_decay:
                u = u + (-self.weight_decay) * params[k]
            updates[k] = u
        for k in params:
            if k not in updates:
                updates[k] = torch.zeros_like(params[k])
        return updates, OptState(count=count, mu=mu, nu=nu, nu_max=nu_max,
                                 mini_step=state.mini_step,
                                 gradient_step=state.gradient_step,
                                 acc_grads=state.acc_grads)

    def update(self, grads: dict, state: OptState, params: dict):
        """(updates, new state); a name missing from ``grads`` has a zero
        gradient."""
        grads = {k: grads[k] if k in grads else torch.zeros_like(v)
                 for k, v in params.items()}
        if self.every_k <= 1:
            return self._inner(grads, state, params)
        n = state.mini_step
        acc = {k: state.acc_grads[k] + (grads[k].float() - state.acc_grads[k])
               / (n + 1) for k in params}
        if n < self.every_k - 1:
            return ({k: torch.zeros_like(v) for k, v in params.items()},
                    dataclasses.replace(state, mini_step=n + 1,
                                        acc_grads=acc))
        updates, inner = self._inner(acc, state, params)
        return updates, dataclasses.replace(
            inner, mini_step=0, gradient_step=state.gradient_step + 1,
            acc_grads={k: torch.zeros_like(v) for k, v in acc.items()})


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """params += updates, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def make_optimizer(params, opt_cfg, sched_cfg, total_steps: int,
                   trainable_modules: Sequence[str],
                   gradient_clip_val: float = 1.0,
                   accumulate_grad_batches: int = 1) -> Optimizer:
    """The JAX package's ``make_optimizer`` (same config knobs); ``params``
    is only read for its names."""
    del params
    lr = float(opt_cfg.get("lr", 1e-4))
    if bool(sched_cfg.get("enabled", True)):
        wf = opt_cfg.get("warmup_factor", None)
        warmup = (int(total_steps * float(wf)) if wf is not None
                  else int(sched_cfg.get("warmup_steps", 500)))
        warmup = min(warmup, max(total_steps - 1, 0))
        schedule = cosine_schedule_with_warmup(
            lr, warmup, total_steps, float(sched_cfg.get("num_cycles", 0.5)))
    else:
        schedule = lr
    betas = opt_cfg.get("betas", [0.9, 0.999])
    return Optimizer(
        train=lambda name: top_level_label(name.split(".")[0],
                                           trainable_modules) == "train",
        schedule=schedule, b1=float(betas[0]), b2=float(betas[1]),
        eps=float(opt_cfg.get("eps", 1e-8)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
        amsgrad=bool(opt_cfg.get("amsgrad", False)),
        adamw=str(opt_cfg.get("type", "AdamW")).lower() == "adamw",
        clip=float(gradient_clip_val),
        every_k=int(accumulate_grad_batches))
