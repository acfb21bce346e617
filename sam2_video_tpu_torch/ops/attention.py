"""Attention primitives (counterpart of ``sam2_video_tpu/ops/attention.py``).

``sdpa`` is written out as product -> float32 softmax -> cast -> product,
the JAX package's dtype walk: both products accumulate in float32, the
logits are never rounded, and the probabilities are cast to the value
dtype before PV.
"""

from __future__ import annotations

import math

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """q [..., Lq, D], k [..., Lk, D], v [..., Lk, Dv]; additive ``bias``
    broadcastable to [..., Lq, Lk]. Output in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., L, H*D] -> [..., H, L, D]."""
    *lead, L, C = x.shape
    return x.reshape(*lead, L, num_heads, C // num_heads).transpose(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, L, D] -> [..., L, H*D]."""
    x = x.transpose(-2, -3)
    *lead, L, H, D = x.shape
    return x.reshape(*lead, L, H * D)
