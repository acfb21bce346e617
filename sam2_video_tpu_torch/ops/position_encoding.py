"""Position encodings, the counterpart of
``sam2_video_tpu/ops/position_encoding.py``.

- ``sine_pe_2d`` / ``sine_pe_1d``: PositionEmbeddingSine and get_1d_sine_pe.
- ``random_pe_*``: the prompt encoder's random-Fourier point encoding.
- ``axial_rope_table_half`` / ``deinterleave_perm`` / ``apply_rope_half``:
  axial RoPE in the de-interleaved ("rotate-half") layout. The row
  permutation is applied to the q/k projection weights, which leaves q.k^T
  unchanged, so the rotation is one multiply-add with a half swap.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sine_pe_2d(h: int, w: int, num_pos_feats: int,
               temperature: float = 10000.0, normalize: bool = True,
               scale: float | None = None) -> torch.Tensor:
    """[H, W, C] float32 sine embedding; channels are (pos_y, pos_x)."""
    if num_pos_feats % 2:
        raise ValueError("num_pos_feats must be even")
    npf = num_pos_feats // 2
    if scale is None:
        scale = 2 * math.pi
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones(
        (1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(
        1, w + 1, dtype=np.float32)[None, :]
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(npf, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / npf)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, npf)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, npf)
    return torch.from_numpy(
        np.concatenate([pos_y, pos_x], axis=2).astype(np.float32))


def sine_pe_1d(pos: torch.Tensor, dim: int,
               temperature: float = 10000.0) -> torch.Tensor:
    """[...] positions -> [..., dim] float32 embedding."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / pe_dim)
    pe = pos.float()[..., None] / dim_t
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=-1)


# ---------------------------------------------------------------------------
# Random-Fourier point PE (SAM prompt encoder)
# ---------------------------------------------------------------------------


def random_pe_init(gen: torch.Generator, num_pos_feats: int,
                   scale: float | None = None):
    if scale is None or scale <= 0.0:
        scale = 1.0
    return {"positional_encoding_gaussian_matrix":
            scale * torch.randn((2, num_pos_feats), generator=gen)}


def _random_pe_encode(p, coords: torch.Tensor) -> torch.Tensor:
    g = p["positional_encoding_gaussian_matrix"].float()
    c = 2.0 * coords.float() - 1.0
    c = 2.0 * math.pi * (c @ g)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def random_pe_grid(p, h: int, w: int) -> torch.Tensor:
    """Dense grid PE [H, W, C]."""
    dev = p["positional_encoding_gaussian_matrix"].device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return _random_pe_encode(p, torch.stack([gx, gy], dim=-1))


def random_pe_coords(p, coords: torch.Tensor,
                     image_size: tuple[int, int]) -> torch.Tensor:
    """coords [..., 2] in pixels (x, y) -> [..., C]."""
    scale = torch.tensor([1.0 / image_size[1], 1.0 / image_size[0]],
                         dtype=torch.float32, device=coords.device)
    return _random_pe_encode(p, coords.float() * scale)


# ---------------------------------------------------------------------------
# Axial RoPE (memory attention), de-interleaved layout
# ---------------------------------------------------------------------------


def axial_rope_table_half(dim: int, end_x: int, end_y: int,
                          theta: float = 10000.0,
                          device: torch.device | str = "cpu"):
    """(cos, sin), each [end_x*end_y, dim] float32: position j and
    j + dim//2 carry the angle of pair j; the first dim//4 pairs rotate by
    the x position, the last dim//4 by the y position."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4].astype(
        np.float32) / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x = t % end_x
    t_y = np.floor(t / end_x)
    ang = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)],
                         axis=-1).astype(np.float32)
    ang = torch.from_numpy(ang).to(device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def deinterleave_perm(d_model: int, num_heads: int) -> np.ndarray:
    """Row permutation moving each head's even features to the first half
    of the head dim and the odd ones to the second half."""
    dh = d_model // num_heads
    within = np.concatenate([np.arange(0, dh, 2), np.arange(1, dh, 2)])
    return (np.arange(num_heads)[:, None] * dh + within[None, :]).reshape(-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Rotate de-interleaved pairs of x [..., L, D] by (cos, sin) [L, D],
    in x's dtype (as the JAX package does)."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin
