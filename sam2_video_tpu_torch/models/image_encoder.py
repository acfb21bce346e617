"""FPN neck over the Hiera trunk (counterpart of
``sam2_video_tpu/models/image_encoder.py``): 1x1 lateral convs to d_model,
nearest 2x top-down fusion on ``fpn_top_down_levels``, sine PEs per level,
``scalp`` drops the lowest-resolution level. NHWC throughout."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import common as nn
from ..ops.position_encoding import sine_pe_2d
from ..ops.resize import resize_nearest
from . import hiera


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    trunk: hiera.HieraConfig = dataclasses.field(
        default_factory=lambda: hiera.HIERA_PRESETS["tiny"])
    d_model: int = 256
    scalp: int = 1
    fpn_top_down_levels: tuple = (2, 3)
    num_pos_feats: int = 256

    @property
    def backbone_channel_list(self) -> tuple:
        return self.trunk.channel_list


def init(gen: torch.Generator, cfg: ImageEncoderConfig):
    neck = {"convs": {str(i): {"conv": nn.conv2d_init(gen, ch, cfg.d_model, 1)}
                      for i, ch in enumerate(cfg.backbone_channel_list)}}
    return {"trunk": hiera.init(gen, cfg.trunk), "neck": neck}


def apply(p, x: torch.Tensor, cfg: ImageEncoderConfig,
          fused_vjp: bool = False):
    """x [B, H, W, 3] -> dict(backbone_fpn=[NHWC high-res first, post
    scalp], vision_pos_enc=[[H, W, C] float32], vision_features).
    ``fused_vjp`` routes the trunk's blocks through the trainable block
    (``hiera.apply``)."""
    xs = hiera.apply(p["trunk"], x, cfg.trunk, fused_vjp=fused_vjp)
    n = len(xs) - 1
    out = [None] * len(xs)
    pos = [None] * len(xs)
    prev = None
    for i in range(n, -1, -1):
        lateral = nn.conv2d(p["neck"]["convs"][str(n - i)]["conv"], xs[i])
        if i in cfg.fpn_top_down_levels and prev is not None:
            h, w = lateral.shape[1], lateral.shape[2]
            top_down = resize_nearest(prev.float().permute(0, 3, 1, 2), (h, w))
            prev = lateral + top_down.permute(0, 2, 3, 1).to(lateral.dtype)
        else:
            prev = lateral
        out[i] = prev
        pos[i] = sine_pe_2d(prev.shape[1], prev.shape[2],
                            cfg.num_pos_feats).to(prev.device)
    if cfg.scalp > 0:
        out, pos = out[: -cfg.scalp], pos[: -cfg.scalp]
    return {"backbone_fpn": out, "vision_pos_enc": pos,
            "vision_features": out[-1]}
