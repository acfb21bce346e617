"""SAM prompt encoder (counterpart of
``sam2_video_tpu/models/prompt_encoder.py``). Point labels: -1 pad, 0 neg,
1 pos, 2/3 box corners; a box is two labelled corner points."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import common as nn
from ..ops.position_encoding import (random_pe_coords, random_pe_grid,
                                     random_pe_init)


@dataclasses.dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: tuple = (24, 24)
    input_image_size: tuple = (384, 384)
    mask_in_chans: int = 16


def init(gen: torch.Generator, cfg: PromptEncoderConfig):
    c = cfg.mask_in_chans
    return {
        "pe_layer": random_pe_init(gen, cfg.embed_dim // 2),
        "point_embeddings": {str(i): nn.embedding_init(gen, 1, cfg.embed_dim)
                             for i in range(4)},
        "not_a_point_embed": nn.embedding_init(gen, 1, cfg.embed_dim),
        "no_mask_embed": nn.embedding_init(gen, 1, cfg.embed_dim),
        "mask_downscaling": {
            "0": nn.conv2d_init(gen, 1, c // 4, 2),
            "1": nn.layer_norm_init(c // 4),
            "3": nn.conv2d_init(gen, c // 4, c, 2),
            "4": nn.layer_norm_init(c),
            "6": nn.conv2d_init(gen, c, cfg.embed_dim, 1),
        },
    }


def get_dense_pe(p, cfg: PromptEncoderConfig) -> torch.Tensor:
    """[H, W, C] float32 PE over the image-embedding grid."""
    h, w = cfg.image_embedding_size
    return random_pe_grid(p["pe_layer"], h, w)


def embed_points(p, cfg: PromptEncoderConfig, coords: torch.Tensor,
                 labels: torch.Tensor, pad: bool = True) -> torch.Tensor:
    """coords [B, P, 2] pixel (x, y), labels [B, P] -> [B, P(+1), C]; with
    ``pad`` one label -1 point is appended (no box prompt)."""
    coords = coords.float() + 0.5
    if pad:
        B = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros((B, 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((B, 1))], dim=1)
    pe = random_pe_coords(p["pe_layer"], coords, cfg.input_image_size)
    type_table = torch.cat(
        [p["not_a_point_embed"]["weight"]]
        + [p["point_embeddings"][str(i)]["weight"] for i in range(4)], dim=0)
    type_emb = type_table[(labels.long() + 1)]
    is_pad = (labels == -1)[..., None]
    return torch.where(is_pad, type_emb, pe + type_emb)


def embed_masks(p, masks: torch.Tensor) -> torch.Tensor:
    """masks [B, 4*H16, 4*W16, 1] -> dense embeddings [B, H16, W16, C]."""
    md = p["mask_downscaling"]
    x = nn.gelu(nn.layer_norm_2d(md["1"], nn.conv2d(md["0"], masks, stride=2)))
    x = nn.gelu(nn.layer_norm_2d(md["4"], nn.conv2d(md["3"], x, stride=2)))
    return nn.conv2d(md["6"], x)


def no_mask_dense(p, cfg: PromptEncoderConfig, batch: int) -> torch.Tensor:
    h, w = cfg.image_embedding_size
    e = p["no_mask_embed"]["weight"].reshape(1, 1, 1, -1)
    return e.expand(batch, h, w, cfg.embed_dim)
