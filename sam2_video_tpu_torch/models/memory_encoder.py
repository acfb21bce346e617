"""Memory encoder (counterpart of ``sam2_video_tpu/models/memory_encoder.py``):
fuses the frame's pixel features with its predicted mask into a 64-dim
spatial memory. NHWC throughout.

``apply`` runs the hand-written memory-encoder kernel through its wrapper
(``ops/memory_encoder_kernel.py``); ``apply_unfused`` is the plain path the
kernel is held against: the mask downsampler, + projected pixels, the two
CXBlocks and ``out_proj``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import common as nn
from ..ops.position_encoding import sine_pe_2d


@dataclasses.dataclass(frozen=True)
class MemoryEncoderConfig:
    out_dim: int = 64
    in_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_downsampler_total_stride: int = 16
    fuser_num_layers: int = 2
    fuser_dim: int = 256
    fuser_kernel: int = 7
    fuser_padding: int = 3
    layer_scale_init_value: float = 1e-6
    num_pos_feats: int = 64


def _num_down_layers(cfg: MemoryEncoderConfig) -> int:
    return int(math.log2(cfg.mask_downsampler_total_stride)
               // math.log2(cfg.mask_downsampler_stride))


def _mask_downsampler_init(gen, cfg: MemoryEncoderConfig):
    s = cfg.mask_downsampler_stride
    layers = {}
    in_ch, idx = 1, 0
    for _ in range(_num_down_layers(cfg)):
        out_ch = in_ch * s * s
        layers[str(idx)] = nn.conv2d_init(gen, in_ch, out_ch,
                                          cfg.mask_downsampler_kernel)
        layers[str(idx + 1)] = nn.layer_norm_init(out_ch)
        idx += 3  # conv, norm, act: the act keeps the torch indices
        in_ch = out_ch
    layers[str(idx)] = nn.conv2d_init(gen, in_ch, cfg.fuser_dim, 1)
    return {"encoder": layers}


def s2d_eligible(cfg: MemoryEncoderConfig, hw) -> bool:
    """The default k3/s2/p1 total-stride-16 geometry on a grid divisible
    by 16: the space-to-depth formulation applies."""
    return (cfg.mask_downsampler_stride == 2
            and cfg.mask_downsampler_kernel == 3
            and cfg.mask_downsampler_padding == 1
            and cfg.mask_downsampler_total_stride == 16
            and hw[0] % 16 == 0 and hw[1] % 16 == 0)


def _mask_downsampler(p, cfg: MemoryEncoderConfig, x):
    if s2d_eligible(cfg, x.shape[1:3]):
        return _mask_downsampler_s2d(p, cfg, x)
    return _mask_downsampler_naive(p, cfg, x)


def _mask_downsampler_naive(p, cfg: MemoryEncoderConfig, x):
    enc = p["encoder"]
    idx = 0
    for _ in range(_num_down_layers(cfg)):
        x = nn.conv2d(enc[str(idx)], x, stride=cfg.mask_downsampler_stride,
                      padding=cfg.mask_downsampler_padding)
        x = nn.gelu(nn.layer_norm_2d(enc[str(idx + 1)], x))
        idx += 3
    return nn.conv2d(enc[str(idx)], x)


# --- space-to-depth form of the downsampler pyramid ------------------------
# Every intermediate stays at the final 1/16 resolution with the phases
# packed into the channel axis (lane = channel * phases + phase); each
# k3/s2/p1 conv becomes an exact 2x2 conv over the packed layout whose
# weights route each tap to its phase.

# (channels in, in-phase grid, channels out, out-phase grid) per conv layer
GEOMETRY = ((1, 16, 4, 8), (4, 8, 16, 4), (16, 4, 64, 2), (64, 2, 256, 1))


@functools.lru_cache(maxsize=None)
def _phase_route(g_in: int, g_out: int) -> np.ndarray:
    """R[h, ri, ro, a] = 1 iff input phase ri feeds output phase ro through
    tap a of a k3/s2/p1 conv, with block offset h-1."""
    R = np.zeros((2, g_in, g_out, 3), np.float32)
    for ro in range(g_out):
        for a in range(3):
            q = 2 * ro + a - 1
            R[0 if q < 0 else 1, q % g_in, ro, a] = 1.0
    return R


def effective_weight(w: torch.Tensor, g_in: int, g_out: int) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> packed-phase HWIO kernel
    [2, 2, Cin*g_in^2, Cout*g_out^2] (lane order channel-major, then row
    phase, then column phase)."""
    R = torch.from_numpy(_phase_route(g_in, g_out)).to(w.device)
    w_hwio = w.float().permute(2, 3, 1, 0)
    weff = torch.einsum("hpqa,wrsb,abio->hwiproqs", R, R, w_hwio)
    cin, cout = w.shape[1], w.shape[0]
    return weff.reshape(2, 2, cin * g_in * g_in, cout * g_out * g_out)


def space_to_depth16(masks: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 1] -> [N, H/16, W/16, 256], lane = 16*row + col."""
    N, H, W, _ = masks.shape
    h, w = H // 16, W // 16
    x = masks.reshape(N, h, 16, w, 16).permute(0, 1, 3, 2, 4)
    return x.reshape(N, h, w, 256)


def _packed_layer_norm(pln, x, channels: int, phases: int,
                       eps: float = 1e-6):
    """LayerNorm over the channel group of a phase-packed channel axis."""
    s = x.shape
    xf = x.float().reshape(s[:-1] + (channels, phases))
    mu = xf.mean(dim=-2, keepdim=True)
    var = (xf.square().mean(dim=-2, keepdim=True) - mu.square()).clamp_min(0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * pln["weight"].float().reshape(channels, 1) \
        + pln["bias"].float().reshape(channels, 1)
    return y.reshape(s).to(x.dtype)


def _mask_downsampler_s2d(p, cfg: MemoryEncoderConfig, x):
    """x [N, H, W, 1] -> [N, H/16, W/16, fuser_dim]."""
    x = space_to_depth16(x)
    enc = p["encoder"]
    idx = 0
    for ci, gi, co, go in GEOMETRY:
        cp = enc[str(idx)]
        weff = effective_weight(cp["weight"], gi, go).to(x.dtype)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 0, 1, 0)),
                     weff.permute(3, 2, 0, 1))
        x = y.permute(0, 2, 3, 1) + cp["bias"].repeat_interleave(
            go * go).to(x.dtype)
        x = nn.gelu(_packed_layer_norm(enc[str(idx + 1)], x, co, go * go))
        idx += 3
    return nn.conv2d(enc[str(idx)], x)


def _cx_block_init(gen, cfg: MemoryEncoderConfig):
    d = cfg.fuser_dim
    return {
        "dwconv": nn.conv2d_init(gen, d, d, cfg.fuser_kernel, groups=d),
        "norm": nn.layer_norm_init(d),
        "pwconv1": nn.linear_init(gen, d, 4 * d),
        "pwconv2": nn.linear_init(gen, 4 * d, d),
        "gamma": cfg.layer_scale_init_value * torch.ones(d),
    }


def _cx_block(p, cfg: MemoryEncoderConfig, x):
    inp = x
    x = nn.conv2d(p["dwconv"], x, padding=cfg.fuser_padding,
                  groups=cfg.fuser_dim)
    x = nn.layer_norm_2d(p["norm"], x)
    x = nn.linear(p["pwconv2"], nn.gelu(nn.linear(p["pwconv1"], x)))
    return inp + p["gamma"].to(x.dtype) * x


def init(gen: torch.Generator, cfg: MemoryEncoderConfig):
    p = {
        "mask_downsampler": _mask_downsampler_init(gen, cfg),
        "pix_feat_proj": nn.conv2d_init(gen, cfg.in_dim, cfg.in_dim, 1),
        "fuser": {"layers": {str(i): _cx_block_init(gen, cfg)
                             for i in range(cfg.fuser_num_layers)}},
    }
    if cfg.out_dim != cfg.in_dim:
        p["out_proj"] = nn.conv2d_init(gen, cfg.in_dim, cfg.out_dim, 1)
    return p


def apply_unfused(p, cfg: MemoryEncoderConfig, pix_proj, masks):
    """Plain path from the projected pixels: downsampler(masks) + pix_proj
    -> CXBlocks -> out_proj. Returns [N, h, w, out_dim]."""
    x = pix_proj + _mask_downsampler(p["mask_downsampler"], cfg, masks)
    for i in range(cfg.fuser_num_layers):
        x = _cx_block(p["fuser"]["layers"][str(i)], cfg, x)
    if "out_proj" in p:
        x = nn.conv2d(p["out_proj"], x)
    return x


def apply(p, cfg: MemoryEncoderConfig, pix_feat, masks,
          allow_fused: bool = True):
    """pix_feat [B, H16, W16, C]; masks [B, H, W, 1], already through the
    scaled sigmoid. Returns (memory [B, H16, W16, out_dim], pos enc
    [H16, W16, out_dim] float32). ``allow_fused`` routes through the
    forward-only kernel's wrapper, else the plain path (differentiable)."""
    from ..ops.memory_encoder_kernel import fused_memory_encoder

    pix_proj = nn.conv2d(p["pix_feat_proj"], pix_feat)
    x = (fused_memory_encoder(p, cfg, pix_proj, masks) if allow_fused
         else apply_unfused(p, cfg, pix_proj, masks))
    pos = sine_pe_2d(x.shape[1], x.shape[2], cfg.num_pos_feats).to(x.device)
    return x, pos
