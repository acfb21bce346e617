"""Training losses (counterpart of ``sam2_video_tpu/training/losses.py``):
``multi_step_loss`` (focal + dice + IoU over every frame's multimask
outputs) and ``bce_category_loss``.

Category validity is a mask, and the normalisation keeps the reference's
arithmetic with static shapes: per frame, every loss row is divided by the
number of valid rows of the flattened [C, M] grid and the frames are
summed. A frame without a valid mask adds zero and is counted in
``frames_without_valid``. All losses are taken in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

CORE_LOSS_KEY = "total_loss"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The same fields and defaults as the JAX package's LossConfig."""
    type: str = "multi_step"                  # {multi_step, bce}
    gt_stride: int = 1
    weight_dict: Any = dataclasses.field(default_factory=lambda: {
        "loss_mask": 20.0, "loss_dice": 1.0, "loss_iou": 1.0,
        "loss_class": 0.0})
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    supervise_all_iou: bool = True
    iou_use_l1_loss: bool = True
    pred_obj_scores: bool = False
    focal_gamma_obj_score: float = 0.0
    focal_alpha_obj_score: float = -1.0
    multistep_logit_temperature: float = 1.0
    bce_logit_temperature: float = 1.0
    bce_pos_weight: Any = None
    bce_reduction: str = "mean"


def _bce_logits(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _sigmoid_focal(inputs, targets, alpha: float, gamma: float):
    """Per-element focal loss in float32."""
    inputs, targets = inputs.float(), targets.float()
    ce = _bce_logits(inputs, targets)
    prob = torch.sigmoid(inputs)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def _dice_per_row(inputs, targets):
    """[..., HW] logits and binary targets -> [...] dice loss."""
    p = torch.sigmoid(inputs.float())
    t = targets.float()
    num = 2 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    return 1 - (num + 1) / (den + 1)


def _actual_iou(inputs, targets):
    pred, gt = inputs > 0, targets > 0
    inter = (pred & gt).sum(-1).float()
    union = (pred | gt).sum(-1).float()
    return inter / union.clamp(min=1.0)


def multi_step_loss(cfg: LossConfig, per_cat: dict, targets: torch.Tensor):
    """per_cat: high_res_multimasks [T, C, M, H, W], ious [T, C, M],
    object_score_logits [T, C, 1]; targets [T, C, H, W] bool. Returns a
    dict of scalar losses with CORE_LOSS_KEY."""
    src = per_cat["high_res_multimasks"].float()
    src = src / cfg.multistep_logit_temperature
    T, C, M, H, W = src.shape
    valid = targets.sum(dim=(-2, -1)) > 0                    # [T, C]
    validm = valid[:, :, None].expand(T, C, M)
    num_obj = validm.sum(dim=(1, 2)).clamp(min=1).float()    # [T]
    flat_src = src.reshape(T, C, M, H * W)
    flat_tgt = targets[:, :, None].float().expand(T, C, M, H, W).reshape(
        T, C, M, H * W)

    focal = _sigmoid_focal(flat_src, flat_tgt, cfg.focal_alpha,
                           cfg.focal_gamma).mean(-1)         # [T, C, M]
    dice = _dice_per_row(flat_src, flat_tgt)
    ious = per_cat["ious"].float()
    actual = _actual_iou(flat_src, flat_tgt)
    iou_err = ((ious - actual).abs() if cfg.iou_use_l1_loss
               else (ious - actual) ** 2)

    vm = validm.float()
    loss_mask = ((focal * vm).sum(dim=(1, 2)) / num_obj).sum()
    loss_dice = ((dice * vm).sum(dim=(1, 2)) / num_obj).sum()
    loss_iou = ((iou_err * vm).sum(dim=(1, 2)) / num_obj).sum()
    if cfg.pred_obj_scores:
        osl = per_cat["object_score_logits"].float()
        cls = _sigmoid_focal(osl, valid[:, :, None].float(),
                             cfg.focal_alpha_obj_score,
                             cfg.focal_gamma_obj_score)[..., 0]
        loss_class = ((cls * valid.float()).sum(1) / num_obj).sum()
    else:
        loss_class = src.new_zeros(())

    losses = {"loss_mask": loss_mask, "loss_dice": loss_dice,
              "loss_iou": loss_iou, "loss_class": loss_class}
    total = src.new_zeros(())
    for k, w in cfg.weight_dict.items():
        if float(w) != 0.0:
            total = total + float(w) * losses[k]
    losses[CORE_LOSS_KEY] = total
    losses["frames_without_valid"] = (valid.sum(1) == 0).float().sum()
    return losses


def bce_category_loss(cfg: LossConfig, per_cat: dict, targets: torch.Tensor):
    """BCE with logits over the valid category channels, averaged over the
    frames. per_cat high_res_masks [T, C, 1, H, W]."""
    logits = per_cat["high_res_masks"].float()[:, :, 0]
    logits = logits / cfg.bce_logit_temperature
    t = targets.float()
    valid = t.sum(dim=(-2, -1)) > 0
    ce = _bce_logits(logits, t)
    if cfg.bce_pos_weight is not None:
        pw = torch.as_tensor(cfg.bce_pos_weight, dtype=torch.float32,
                             device=logits.device).reshape(1, -1, 1, 1)
        ce = torch.where(t > 0, pw * ce, ce)
    vm = valid[:, :, None, None].float()
    H, W = logits.shape[-2:]
    cnt = valid.sum(1).clamp(min=1).float()
    if cfg.bce_reduction == "mean":
        per_frame = (ce * vm).sum(dim=(1, 2, 3)) / (cnt * H * W)
    else:
        per_frame = (ce * vm).sum(dim=(1, 2, 3))
    total = per_frame.mean()
    return {"loss_bce": total, CORE_LOSS_KEY: total,
            "frames_without_valid": (valid.sum(1) == 0).float().sum()}


def apply_gt_stride(per_cat: dict, targets: torch.Tensor, gt_stride: int):
    """Frames 0, k, 2k, ... for the loss."""
    if gt_stride <= 1:
        return per_cat, targets
    idx = torch.arange(0, targets.shape[0], gt_stride, device=targets.device)
    return {k: v[idx] for k, v in per_cat.items()}, targets[idx]


def compute_loss(cfg: LossConfig, per_cat: dict, targets: torch.Tensor):
    per_cat, targets = apply_gt_stride(per_cat, targets, cfg.gt_stride)
    if cfg.type in ("bce", "bce_only", "ce_only"):
        return bce_category_loss(cfg, per_cat, targets)
    return multi_step_loss(cfg, per_cat, targets)
