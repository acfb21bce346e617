"""Memory encoder forward as a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``sam2_video_tpu/ops/memory_encoder_kernel.py``
``fused_memory_encoder`` (Pallas ``_kernel``). Source:
``csrc/memory_encoder.cu`` (shared GEMM / LayerNorm device code in
``csrc/common.cuh``).

- On H100 at 384 px with 8 objects the function needs ~12.5 GFLOP of
  products (the k3/s2 pyramid at its own resolutions 1.8 of them) on ~8 MB
  of inputs, output and weights, so the tensor cores bound it. Each 2x2
  phase-routed conv is one K = 1024 product whose A tiles are read through
  an implicit im2col of the four shifted taps (9.7 GFLOP for the pyramid,
  the zeros of the phase routing included), and the bias, GELU, layer
  scale and residuals ride in the GEMM epilogue.
- The space-to-depth input is phase-packed (lane = channel * phases +
  phase); the 2x2 weights come from ``models/memory_encoder.py``
  ``effective_weight``. The packed LayerNorm is a per-phase-group
  reduction; the depthwise 7x7 (zero padding 3) is a per-channel loop.
- GELU uses CUDA's ``erff``; the kernel rounds once per stage where the
  plain version rounds after each op, which chip_smoke.py bounds at 2e-2
  of the output scale.

The wrapper takes ``pix_proj`` already through ``pix_feat_proj`` (as the JAX
wrapper does) and returns [N, h, w, out_dim] in the mask dtype. It takes
the plain version for CPU tensors and launches the kernel for CUDA
tensors (or raises). ``fused_memory_encoder.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import memory_encoder as me
from . import common as nn
from . import kernel_build

_NUM_WEIGHTS = 38


def fused_memory_encoder_plain(p, cfg, pix_proj, masks):
    """The plain PyTorch path (``models/memory_encoder.py``
    ``apply_unfused``): downsampler + pix_proj -> CXBlocks -> out_proj."""
    return me.apply_unfused(p, cfg, pix_proj, masks)


def eligible(cfg) -> bool:
    return (me.s2d_eligible(cfg, (16, 16)) and cfg.fuser_num_layers == 2
            and cfg.fuser_dim == 256 and cfg.in_dim == 256
            and cfg.out_dim != cfg.in_dim
            and cfg.fuser_kernel == 7 and cfg.fuser_padding == 3)


def _conv2x2_weight(w, gi: int, go: int):
    """OIHW 3x3 -> [256 out, 4 taps * 256 in] bf16, column = tap * 256 +
    packed input lane (the implicit-im2col order of ``Conv2x2A``)."""
    weff = me.effective_weight(w, gi, go)              # [2, 2, in, out]
    return weff.permute(3, 0, 1, 2).reshape(weff.shape[3], -1).to(
        torch.bfloat16).contiguous()


def _dw_weight(w):
    """Depthwise OIHW [C, 1, 7, 7] -> [49, C] f32 of the bf16 weights."""
    return w[:, 0].to(torch.bfloat16).float().reshape(w.shape[0], -1).t(
        ).contiguous()


def pack(p, cfg):
    """Weight table in the order of ``memory_encoder_fwd`` (csrc) and the
    packed phases per downsampler layer. ``models/sam2.py`` ``prepare``
    keeps them on the tree as the memory encoder's ``_ops`` entry."""
    def bf(t):
        return t.to(torch.bfloat16)

    def f32(t):
        return t.float()

    def bf_1x1(t):
        return t.flatten(1).to(torch.bfloat16)

    enc = p["mask_downsampler"]["encoder"]
    wt, phases = [], []
    idx = 0
    for ci, gi, co, go in me.GEOMETRY:
        cp, ln = enc[str(idx)], enc[str(idx + 1)]
        wt += [_conv2x2_weight(cp["weight"], gi, go),
               cp["bias"].float().repeat_interleave(go * go),
               f32(ln["weight"]), f32(ln["bias"])]
        phases.append(go * go)
        idx += 3
    fin = enc[str(idx)]
    wt += [bf_1x1(fin["weight"]), f32(fin["bias"])]
    for i in range(cfg.fuser_num_layers):
        cx = p["fuser"]["layers"][str(i)]
        wt += [_dw_weight(cx["dwconv"]["weight"]),
               f32(cx["dwconv"]["bias"]),
               f32(cx["norm"]["weight"]), f32(cx["norm"]["bias"]),
               bf(cx["pwconv1"]["weight"]), f32(cx["pwconv1"]["bias"]),
               bf(cx["pwconv2"]["weight"]), f32(cx["pwconv2"]["bias"]),
               f32(cx["gamma"])]
    wt += [bf_1x1(p["out_proj"]["weight"]), f32(p["out_proj"]["bias"])]
    return wt, phases


def fused_memory_encoder(p, cfg, pix_proj, masks):
    """pix_proj [N, h, w, 256] already through pix_feat_proj; masks
    [N, 16h, 16w, 1] scaled-sigmoid masks. Returns [N, h, w, out_dim]."""
    if masks.device.type == "cpu":
        return fused_memory_encoder_plain(p, cfg, pix_proj, masks)
    if not masks.is_cuda:
        raise ValueError(f"fused_memory_encoder: unsupported device "
                         f"{masks.device}")
    nn.forward_only("fused_memory_encoder", "its output may feed only a "
                    "detached memory bank (models/sam2.py "
                    "encode_new_memory runs it under torch.no_grad)", p,
                    masks, pix_proj)
    if not eligible(cfg):
        raise ValueError("fused_memory_encoder kernel takes the default "
                         "SAM2 geometry (k3/s2/p1 stride-16 downsampler, "
                         "two 256-wide CXBlocks, 7x7 depthwise, out_proj)")
    for name, t in (("masks", masks), ("pix_proj", pix_proj)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_memory_encoder kernel takes bfloat16 "
                            f"{name}, got {t.dtype}")
        if t.device != masks.device:
            raise ValueError("masks and pix_proj on different devices")
    N, H, W, one = masks.shape
    h, w = H // 16, W // 16
    if one != 1 or H != 16 * h or W != 16 * w:
        raise ValueError(f"masks must be [N, 16h, 16w, 1], got {masks.shape}")
    if tuple(pix_proj.shape) != (N, h, w, 256):
        raise ValueError(f"pix_proj must be {(N, h, w, 256)}, got "
                         f"{tuple(pix_proj.shape)}")
    dev = masks.device
    ms = me.space_to_depth16(masks).contiguous()
    pix = pix_proj.contiguous()
    ops = p.get("_ops")
    wt, phases = pack(p, cfg) if ops is None else ops
    out_dim = wt[36].shape[0]
    M = N * h * w

    def scratch(cols, dtype=torch.bfloat16):
        return torch.empty((M, cols), dtype=dtype, device=dev)

    out = torch.empty((N, h, w, out_dim), dtype=torch.bfloat16, device=dev)
    tmp, act, xa, xb, yb = (scratch(256) for _ in range(5))
    y32 = scratch(256, torch.float32)
    hid = scratch(1024)
    table = (ctypes.c_void_p * _NUM_WEIGHTS)(*(t.data_ptr() for t in wt))
    ph = (ctypes.c_int * 4)(*phases)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.memory_encoder_fwd(
            ms.data_ptr(), pix.data_ptr(), out.data_ptr(), table, ph,
            tmp.data_ptr(), act.data_ptr(), xa.data_ptr(), xb.data_ptr(),
            yb.data_ptr(), y32.data_ptr(), hid.data_ptr(), N, h, w, out_dim,
            stream)
    kernel_build.check_launch(status, "memory_encoder_fwd")
    fused_memory_encoder.launches += 1
    return out


fused_memory_encoder.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("memory_encoder")
    if not getattr(lib, "_sam2_typed", False):
        lib.memory_encoder_fwd.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
            + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.memory_encoder_fwd.restype = ctypes.c_int
        lib.memory_encoder_num_weights.restype = ctypes.c_int
        if lib.memory_encoder_num_weights() != _NUM_WEIGHTS:
            raise RuntimeError("memory_encoder_fwd weight table mismatch")
        lib._sam2_typed = True
    return lib
