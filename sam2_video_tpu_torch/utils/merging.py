"""Per-object predictions merged back to per-category predictions
(counterpart of ``sam2_video_tpu/utils/merging.py``): mask logits by the
pixelwise maximum over a category's objects, IoU and score tensors by an
area-weighted average (weights = summed sigmoid of each object's mask,
the plain mean where the weights vanish). Membership is a one-hot [O, C]
matrix from ``obj_to_cat`` (-1 = padding). The JAX package maps the
per-frame merge over frames with ``jax.vmap``; here the frame axis is a
loop."""

from __future__ import annotations

import torch


def category_onehot(obj_to_cat: torch.Tensor,
                    num_categories: int) -> torch.Tensor:
    """[O] int (-1 = padding) -> [O, C] float32 membership."""
    cats = torch.arange(num_categories, device=obj_to_cat.device)
    return (obj_to_cat[:, None] == cats[None, :]).float()


def grouped_max(x: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """x [O, ...], member [O, C] -> [C, ...]: the maximum over each
    category's objects, 0 for a category without objects. Ties share the
    gradient equally (``amax``), as ``jnp.max`` does."""
    extra = x.ndim - 1
    m = member.reshape(member.shape + (1,) * extra)
    masked = torch.where(m > 0, x[:, None], torch.full_like(x[:, None],
                                                            -torch.inf))
    mx = torch.amax(masked, dim=0)
    has = (member.sum(0) > 0).reshape(member.shape[1:2] + (1,) * extra)
    return torch.where(has, mx, torch.zeros_like(mx))


def grouped_weighted_avg(x: torch.Tensor, member: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """x [O, ...], member [O, C], weights [O] -> [C, ...]: the weighted
    average over each category's objects; the plain mean where the weights
    sum to 0; 0 for a category without objects."""
    extra = x.ndim - 1
    m = member.reshape(member.shape + (1,) * extra)
    w = weights.reshape(-1, *([1] * (1 + extra)))
    xe = x[:, None]
    wsum = (m * w).sum(0)
    wx = (m * w * xe).sum(0)
    cnt = m.sum(0)
    mean = (m * xe).sum(0) / cnt.clamp(min=1.0)
    pos = wsum > 0
    avg = torch.where(pos, wx / torch.where(pos, wsum, torch.ones_like(wsum)),
                      mean)
    return torch.where(cnt > 0, avg, torch.zeros_like(avg))


def merge_objects_to_categories(outs: dict, obj_to_cat: torch.Tensor,
                                num_categories: int) -> dict:
    """outs: [T, O, ...] per-object tensors (high_res_multimasks, ious,
    object_score_logits, high_res_masks, ...). Returns the same keys with
    O -> C. The weights come from each object's high_res_masks."""
    member = category_onehot(obj_to_cat, num_categories)
    frames = []
    for t in range(next(iter(outs.values())).shape[0]):
        frame = {k: v[t] for k, v in outs.items()}
        weights = torch.sigmoid(frame["high_res_masks"]).sum(dim=(1, 2, 3))
        out = {}
        for k in ("low_res_masks", "high_res_masks", "low_res_multimasks",
                  "high_res_multimasks"):
            if k in frame:
                out[k] = grouped_max(frame[k], member)
        for k in ("ious", "object_score_logits"):
            if k in frame:
                out[k] = grouped_weighted_avg(frame[k], member, weights)
        frames.append(out)
    return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
