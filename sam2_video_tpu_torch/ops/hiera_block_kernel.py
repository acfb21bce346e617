"""Hiera block forward as a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``sam2_video_tpu/ops/hiera_block_kernel.py``
``fused_block`` (Pallas ``_block_kernel``). Source: ``csrc/hiera_block.cu``
(the attention passes, geometry and LayerNorm shared with the backward in
``csrc/hiera_attn.cuh``, the GEMM in ``csrc/sm90_gemm.cuh``).

- On H100 at SAM2-tiny 384 px the trunk needs ~30 GFLOP of bf16 products
  per frame (2.5 of them attention) against ~21 MB of block inputs,
  outputs and weights, each moved once, so the tensor cores bound it:
  every product is a wgmma, the projections and the MLP on the pipelined
  GEMM of ``sm90_gemm.cuh`` (qkv and the shortcut one grouped launch; bias,
  GELU and residual in its epilogue; blocks of 64 rows where 128 would
  leave the SMs short), the attention on the passes kernel #6 recomputes
  with (several small windows share a 64-row tile under a block-diagonal
  mask; exact softmax, normalised probabilities rounded to bf16 before PV,
  as sdpa does).
- Pad tokens are real keys: the reference pads after norm1, so LN1 writes
  zero rows at the pad tokens of the window-padded grid and qkv there is
  the rounded bias. q-pool blocks pool 2x2 inside each window and crop the
  pooled grid back to (H/2, W/2), odd pooled windows (7 x 7) included.
- No TPU eligibility rules: every block of the four SAM2 presets (tiny,
  small: widths 96-768, head dim 96; base+: 112-896, head dim 56; large:
  144-1152, head dim 72) runs here, at any image size. The kernel refuses
  (raises, ``check_block``) only shapes its tiles do not cover: a head dim
  over 128 or not a multiple of 8, channel counts that are not multiples
  of 8 (16-byte rows), rows wider than 1280 channels (its LayerNorms).
- GELU uses CUDA's ``erff`` (exact erf); the plain version's bf16 rounding
  points differ from the kernel's single f32 epilogue, which chip_smoke.py
  bounds at 2e-2 of the output scale.

``fused_block`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (or raises); ``fused_block(..., save_residual=
True)`` also returns x1, the residual after attention, which the trainable
block (``ops/hiera_block_bwd.py``) keeps for its backward. Both count
their launches of the kernel in ``fused_block.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import hiera
from . import common as nn
from . import kernel_build


def fused_block_plain(p, x, spec, q_stride, mlp_ratio: float = 4.0):
    """The plain PyTorch block (``models/hiera.py`` ``_block``)."""
    return hiera._block(p, x, spec, q_stride)


def _window(spec, H: int, W: int):
    ws = spec["window_size"]
    return (H, W) if ws == 0 else (ws, ws)


def pack(p, spec):
    """Kernel operands of one block: bf16 product weights in [out, in]
    layout, float32 biases and LayerNorm parameters. ``models/sam2.py``
    ``prepare`` keeps them on the tree as the block's ``_ops`` entry."""
    def bf(t):
        return t.to(torch.bfloat16)

    def f32(t):
        return t.float()

    ap = p["attn"]
    ops = [f32(p["norm1"]["weight"]), f32(p["norm1"]["bias"]),
           bf(ap["qkv"]["weight"]), f32(ap["qkv"]["bias"]),
           bf(ap["proj"]["weight"]), f32(ap["proj"]["bias"]),
           f32(p["norm2"]["weight"]), f32(p["norm2"]["bias"]),
           bf(p["mlp"]["layers"]["0"]["weight"]),
           f32(p["mlp"]["layers"]["0"]["bias"]),
           bf(p["mlp"]["layers"]["1"]["weight"]),
           f32(p["mlp"]["layers"]["1"]["bias"])]
    if spec["dim"] != spec["dim_out"]:
        ops += [bf(p["proj"]["weight"]), f32(p["proj"]["bias"])]
    else:
        ops += [None, None]
    return ops


LN_MAX_C = 1280        # csrc/common.cuh: the widest row a LayerNorm takes


def check_block(Cin: int, spec, q_stride, hidden: int) -> int:
    """Raise ValueError unless kernels #1 and #6 take a block of this spec
    with Cin input channels and an MLP of ``hidden``; returns the head
    dim."""
    Cout, heads = spec["dim_out"], spec["num_heads"]
    if Cin != spec["dim"]:
        raise ValueError(f"x has {Cin} channels, block expects {spec['dim']}")
    if Cin % 8 or Cout % 8 or hidden % 8:
        raise ValueError("fused_block kernel needs channels % 8 == 0")
    if max(Cin, Cout) > LN_MAX_C:
        raise ValueError(f"fused_block kernel takes at most {LN_MAX_C} "
                         f"channels, got {max(Cin, Cout)}")
    hd = Cout // heads
    if hd % 8 or hd > 128:
        raise ValueError(f"fused_block kernel needs head dim % 8 == 0 and "
                         f"<= 128, got {hd}")
    if spec["q_pool"]:
        if tuple(q_stride) != (2, 2):
            raise ValueError("fused_block kernel pools 2x2 only")
        if Cin == Cout:
            raise ValueError("q-pool block without a dim change")
        if spec["window_size"] % 2:
            raise ValueError("q-pool needs an even window")
    return hd


def _check(x, spec, q_stride, hidden: int):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_block kernel takes bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("fused_block kernel takes a contiguous [B, H, W, C]")
    B, H, W, Cin = x.shape
    hd = check_block(Cin, spec, q_stride, hidden)
    return B, H, W, Cin, spec["dim_out"], spec["num_heads"], hd


FORWARD_ONLY = (
    "a trainable trunk runs ops/hiera_block_bwd.py fused_block_trainable "
    "(SAM2Config.fused_backbone_vjp), whose backward is kernel #6")


def fused_block(p, x, spec, q_stride, mlp_ratio: float = 4.0,
                save_residual: bool = False):
    """One Hiera block, same contract as ``models/hiera.py`` ``_block``:
    x [B, H, W, Cin] -> [B, H', W', Cout]; with ``save_residual`` it
    returns ``(out, x1)``, x1 the residual after attention (the JAX
    kernel's ``save_residual``). Forward only: on a CUDA tensor it raises
    where autograd would need the block's backward."""
    if x.device.type == "cpu":
        out = fused_block_plain(p, x, spec, q_stride, mlp_ratio)
        return (out, None) if save_residual else out
    if not x.is_cuda:
        raise ValueError(f"fused_block: unsupported device {x.device}")
    nn.forward_only("fused_block", FORWARD_ONLY, p, x)
    ops = p.get("_ops")
    if ops is None:
        ops = pack(p, spec)
    out, x1 = _launch(ops, x, spec, q_stride, mlp_ratio)
    return (out, x1) if save_residual else out


def _launch(ops, x, spec, q_stride, mlp_ratio: float = 4.0):
    """Run kernel #1 on the packed operands ``ops`` (``pack``): the block's
    output and x1, the residual after attention, which the kernel writes
    into a buffer the caller owns."""
    hidden = int(spec["dim_out"] * mlp_ratio)
    B, H, W, Cin, Cout, heads, _ = _check(x, spec, q_stride, hidden)
    wsh, wsw = _window(spec, H, W)
    lib = _lib()
    q_pool = int(bool(spec["q_pool"]))
    Ho, Wo = (H // 2, W // 2) if q_pool else (H, W)
    geo = (B, H, W, Cin, Cout, heads, hidden, wsh, wsw, q_pool)
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.bfloat16,
                      device=x.device)
    x1 = torch.empty_like(out)
    ws = torch.empty(lib.hiera_fwd_workspace_bytes(
        *geo, int(ops[12] is not None)), dtype=torch.uint8, device=x.device)
    table = (ctypes.c_void_p * len(ops))(*(
        None if t is None else t.data_ptr() for t in ops))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.hiera_block_fwd(x.data_ptr(), out.data_ptr(),
                                     x1.data_ptr(), table, ws.data_ptr(),
                                     *geo, stream)
    kernel_build.check_launch(status, "hiera_block_fwd")
    fused_block.launches += 1
    return out, x1


fused_block.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("hiera_block")
    if not getattr(lib, "_sam2_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hiera_fwd_workspace_bytes.argtypes = [I] * 11
        lib.hiera_fwd_workspace_bytes.restype = ctypes.c_long
        lib.hiera_block_fwd.argtypes = ([P] * 3 + [ctypes.POINTER(P), P]
                                        + [I] * 10 + [P])
        lib.hiera_block_fwd.restype = I
        lib._sam2_typed = True
    return lib
