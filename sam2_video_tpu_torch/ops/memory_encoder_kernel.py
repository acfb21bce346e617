"""Memory encoder forward as a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``sam2_video_tpu/ops/memory_encoder_kernel.py``
``fused_memory_encoder`` (Pallas ``_kernel``). Source:
``csrc/memory_encoder.cu`` (the pipelined wgmma GEMM of
``csrc/sm90_gemm.cuh``, the row LayerNorm of ``csrc/hiera_attn.cuh``).

- On H100 at 384 px with 8 objects the function needs ~12.5 GFLOP of
  products (the k3/s2 pyramid at its own resolutions 1.8 of them) on ~8 MB
  of inputs, output and weights, so the tensor cores bound it. The
  downsampler runs each layer at its own resolution: layers 1 and 2 (1 ->
  4 -> 16 channels) in one direct kernel on the CUDA cores, layers 3 and
  4 as wgmma products with an implicit im2col of the nine taps (the TPU
  kernel's phase-packed K = 1024 products did 9.7 GFLOP, mostly zeros).
  Each CXBlock is two kernels: the depthwise 7x7 (zero padding 3) with
  its LayerNorm over a halo tile in shared memory, then the MLP with its
  1024-wide hidden layer kept in shared memory; bias, GELU, layer scale
  and residuals ride in the epilogues. 10 device operations per call.
- The conv weights enter as OIHW (layers 1-2, f32 of the bf16 weights) or
  as [out, 9 in] bf16 with column (ky 3 + kx) in + ci (layers 3-4).
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


def _conv_weight(w):
    """OIHW 3x3 [out, in, 3, 3] -> [out, 9 in] bf16, column (ky 3 + kx) in
    + ci (the implicit-im2col order of the kernel's conv A)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(
        torch.bfloat16).contiguous()


def _direct_weight(w):
    """OIHW 3x3 -> f32 of the bf16 weights (the direct kernel's layers)."""
    return w.to(torch.bfloat16).float().contiguous()


def _dw_weight(w):
    """Depthwise OIHW [C, 1, 7, 7] -> [49, C] f32 of the bf16 weights."""
    return w[:, 0].to(torch.bfloat16).float().reshape(w.shape[0], -1).t(
        ).contiguous()


def pack(p, cfg):
    """Weight table in the order of ``memory_encoder_fwd`` (csrc).
    ``models/sam2.py`` ``prepare`` keeps it on the tree as the memory
    encoder's ``_ops`` entry."""
    def bf(t):
        return t.to(torch.bfloat16).contiguous()

    def f32(t):
        return t.float().contiguous()

    def bf_1x1(t):
        return t.flatten(1).to(torch.bfloat16).contiguous()

    enc = p["mask_downsampler"]["encoder"]
    wt = []
    idx = 0
    for layer in range(len(me.GEOMETRY)):
        cp, ln = enc[str(idx)], enc[str(idx + 1)]
        conv = _direct_weight if layer < 2 else _conv_weight
        wt += [conv(cp["weight"]), f32(cp["bias"]), f32(ln["weight"]),
               f32(ln["bias"])]
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
    return wt


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
    ms = masks.contiguous()
    pix = pix_proj.contiguous()
    wt = p.get("_ops")
    if wt is None:
        wt = pack(p, cfg)
    out_dim = wt[36].shape[0]
    out = torch.empty((N, h, w, out_dim), dtype=torch.bfloat16, device=dev)
    lib = _lib()
    ws = torch.empty(lib.memory_encoder_workspace_bytes(N, h, w),
                     dtype=torch.uint8, device=dev)
    table = (ctypes.c_void_p * _NUM_WEIGHTS)(*(t.data_ptr() for t in wt))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.memory_encoder_fwd(
            ms.data_ptr(), pix.data_ptr(), out.data_ptr(), table,
            ws.data_ptr(), N, h, w, out_dim, stream)
    kernel_build.check_launch(status, "memory_encoder_fwd")
    fused_memory_encoder.launches += 1
    return out


fused_memory_encoder.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("memory_encoder")
    if not getattr(lib, "_sam2_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.memory_encoder_workspace_bytes.argtypes = [I] * 3
        lib.memory_encoder_workspace_bytes.restype = ctypes.c_long
        lib.memory_encoder_fwd.argtypes = ([P] * 3 + [ctypes.POINTER(P), P]
                                           + [I] * 4 + [P])
        lib.memory_encoder_fwd.restype = I
        lib.memory_encoder_num_weights.restype = I
        if lib.memory_encoder_num_weights() != _NUM_WEIGHTS:
            raise RuntimeError("memory_encoder_fwd weight table mismatch")
        lib._sam2_typed = True
    return lib
