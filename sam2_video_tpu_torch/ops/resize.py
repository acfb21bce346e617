"""Image and feature resizing, the counterpart of
``sam2_video_tpu/ops/resize.py``.

- ``resize_bilinear``: ``jax.image.resize(method="linear")`` in float32,
  as two products with interpolation matrices (``linear_matrix``), one
  along H and one along W. The matrices' rows are the triangle kernel,
  widened by the scale factor when it shrinks (antialias), renormalised
  at the borders. Products have a deterministic backward; torch's
  antialiased ``F.interpolate`` adds its gradient with atomics on CUDA.
- ``resize_nearest``: integer-factor nearest (the FPN's exact 2x top-down).
- ``bicubic_matrix`` / ``resize_bicubic_torch``: torch bicubic (a=-0.75,
  align_corners=False) as two interpolation products, for the Hiera
  background pos-embed.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _as_nchw(x: torch.Tensor):
    lead = x.shape[:-2]
    return x.reshape((-1, 1) + tuple(x.shape[-2:])), lead


@lru_cache(maxsize=32)
def linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] weights of jax.image.resize's 'linear' method
    (``compute_weight_mat``, in its float32 arithmetic): the sample at
    (i + 0.5) in_size / out_size - 0.5, the triangle kernel over
    |sample - j| / max(in_size / out_size, 1), each row divided by its
    sum."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


@lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``linear_matrix`` as a float32 tensor on ``device``, made once."""
    return torch.from_numpy(linear_matrix(in_size, out_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x [..., H, W] -> [..., h, w], computed in float32. An axis whose
    size does not change is left alone, as jax.image.resize does."""
    (h, w), (oh, ow) = x.shape[-2:], tuple(out_hw)
    y = x.float()
    if oh != h:
        y = torch.matmul(_matrix(h, oh, x.device), y)
    if ow != w:
        y = torch.matmul(y, _matrix(w, ow, x.device).t())
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    x4, lead = _as_nchw(x)
    y = F.interpolate(x4, size=tuple(out_hw), mode="nearest")
    return y.reshape(lead + tuple(out_hw))


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0, (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2.0, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a,
                 0.0))


@lru_cache(maxsize=32)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] torch-bicubic interpolation matrix (border
    replication); rows sum to 1."""
    scale = in_size / out_size
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        fs = int(np.floor(src))
        for j in range(fs - 1, fs + 3):
            m[i, min(max(j, 0), in_size - 1)] += _cubic_kernel(src - j)
    return m


def resize_bicubic_torch(x: torch.Tensor,
                         out_hw: tuple[int, int]) -> torch.Tensor:
    """x [..., H, W, C] -> [..., h, w, C], torch bicubic semantics."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    my = torch.from_numpy(bicubic_matrix(h, oh)).to(x.device)
    mx = torch.from_numpy(bicubic_matrix(w, ow)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", my, x.float())
    y = torch.einsum("pw,...owc->...opc", mx, y)
    return y.to(x.dtype)
