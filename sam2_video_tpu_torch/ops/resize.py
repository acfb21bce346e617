"""Image and feature resizing, the counterpart of
``sam2_video_tpu/ops/resize.py``.

- ``resize_bilinear``: half-pixel bilinear in float32. JAX's 'linear'
  resize antialiases when it shrinks, which is torch's ``antialias=True``;
  when it grows the two are plain bilinear.
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


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x [..., H, W] -> [..., h, w], computed in float32."""
    x4, lead = _as_nchw(x.float())
    y = F.interpolate(x4, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(lead + tuple(out_hw)).to(x.dtype)


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
