"""The trainable Hiera block: kernel #1 forward, and its backward as a
hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``sam2_video_tpu/ops/hiera_block_bwd.py``
``fused_block_trainable`` (Pallas ``_mlp_bwd_kernel`` and
``_attn_bwd_kernel``). Source: ``csrc/hiera_block_bwd.cu`` on the wgmma
GEMM of ``csrc/sm90_gemm.cuh`` and the tiles of ``csrc/sm90.cuh``.

- The forward is kernel #1 (``ops/hiera_block_kernel.py``) with
  ``save_residual``: it keeps x1, the residual after attention, the one
  cut point from which both halves of the block can be recomputed.
- B1 recomputes LN2 -> W1 -> exact-erf GELU from x1 and gives dx1 and the
  LN2 / MLP gradients; B2 recomputes LN1, qkv, the shortcut and the
  attention (flash style: the forward's row statistics, then a
  query-tiled dq pass and a key-tiled dk / dv pass, small windows packed
  several to a 64-row tile) and gives dx and the LN1 / qkv / proj /
  shortcut gradients. On H100 the products bound it: every one runs on
  wgmma. One C entry point runs both halves, 12-14 device operations.
- Pad tokens of a padded window are keys (k = bk, v = bv: the reference
  pads after norm1), so their dk and dv flow into dbk and dbv. The 2x2
  max-pool backward (q-pool, dim-change shortcut) routes to the first
  maximum as JAX's ``_unpool2x2_rows_cols`` does (row-pair maxima compare
  the columns first); torch's ``max_pool2d`` autograd, which the plain
  version uses, picks the first in row-major order, so the two differ
  where a 2x2 cell holds a tie.
- No TPU eligibility rules: every block of the SAM2 presets runs here,
  the stage-4 blocks and global attention at any grid included.
- Weight gradients are float32: per-chunk f32 partials added in a fixed
  order (no atomics, the same bits from run to run). The Function takes
  the float32 parameter leaves and returns their gradients in float32, as
  the JAX VJP returns the primal leaves' dtype. Its kernels read the
  block's operand pack (bf16 product weights, ``hiera_block_kernel.pack``)
  as data beside the leaves: ``models/sam2.py`` ``derive`` makes it once
  per train step, and the Function packs the leaves itself only where the
  block has none.

``fused_block_trainable`` takes the plain version for a CPU tensor and
launches the kernels for a CUDA tensor (or raises). ``.launches`` counts
backward launches (one B1 and one B2 per block), and
``.launches_by_geometry`` the same launches per ``geometry`` class; the
forward counts in ``fused_block.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import hiera
from . import hiera_block_kernel as hbk
from . import kernel_build

# leaves of a block in the kernel's operand order (ops/hiera_block_kernel.py
# pack), the shortcut projection last on dim-change blocks
LEAVES = (("norm1", "weight"), ("norm1", "bias"),
          ("attn", "qkv", "weight"), ("attn", "qkv", "bias"),
          ("attn", "proj", "weight"), ("attn", "proj", "bias"),
          ("norm2", "weight"), ("norm2", "bias"),
          ("mlp", "layers", "0", "weight"), ("mlp", "layers", "0", "bias"),
          ("mlp", "layers", "1", "weight"), ("mlp", "layers", "1", "bias"))
SHORTCUT = (("proj", "weight"), ("proj", "bias"))


def fused_block_trainable_plain(p, x, spec, q_stride,
                                mlp_ratio: float = 4.0):
    """The plain PyTorch block (``models/hiera.py`` ``_block``), whose
    gradient autograd gives."""
    return hiera._block(p, x, spec, q_stride)


class _MaxPoolJaxRule(torch.autograd.Function):
    """2x2 max-pool of [N, H, W, C] whose backward routes as JAX's
    _unpool2x2_rows_cols and the kernel do: to the column whose row-pair max
    is larger, then to the larger row, the first on a tie."""

    @staticmethod
    def forward(ctx, x, window, stride):
        ctx.save_for_backward(x)
        return torch.nn.functional.max_pool2d(
            x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        N, H, W, C = x.shape
        Ho, Wo = H // 2, W // 2
        c = x[:, :2 * Ho, :2 * Wo].float().reshape(N, Ho, 2, Wo, 2, C)
        v00, v01 = c[:, :, 0, :, 0], c[:, :, 0, :, 1]
        v10, v11 = c[:, :, 1, :, 0], c[:, :, 1, :, 1]
        col = torch.maximum(v00, v10) < torch.maximum(v01, v11)
        row = torch.where(col, v01 < v11, v00 < v10)
        dx = torch.zeros((N, Ho, 2, Wo, 2, C), dtype=g.dtype,
                         device=g.device)
        for r in (0, 1):
            for cc in (0, 1):
                hit = (row == bool(r)) & (col == bool(cc))
                dx[:, :, r, :, cc] = torch.where(hit, g, torch.zeros_like(g))
        out = torch.zeros_like(x)
        out[:, :2 * Ho, :2 * Wo] = dx.reshape(N, 2 * Ho, 2 * Wo, C)
        return out, None, None


def fused_block_trainable_walk(p, x, spec, q_stride, mlp_ratio: float = 4.0):
    """The plain block with the kernel's walk, a yardstick for the q-pool
    blocks' routed gradients: JAX's max-pool backward rule and the
    kernel's rounding points in its products (bf16 weights, acc + float32
    bias, one bf16 rounding), so that its pre-pool values are the
    kernel's up to float32 summation order, and so are the tie cells."""
    import torch.nn.functional as F

    from . import common as nn

    def linear(pp, v):
        b = pp.get("bias")
        return F.linear(v.float(), pp["weight"].to(v.dtype).float(),
                        None if b is None else b.float()).to(v.dtype)

    saved = nn.max_pool2d, nn.linear
    nn.max_pool2d, nn.linear = _MaxPoolJaxRule.apply, linear
    try:
        return fused_block_trainable_plain(p, x, spec, q_stride, mlp_ratio)
    finally:
        nn.max_pool2d, nn.linear = saved


def _leaf(p, path):
    for k in path:
        p = p[k]
    return p


def paths(spec):
    """Paths of the block's parameters in the kernel's operand order."""
    return LEAVES + (SHORTCUT if spec["dim"] != spec["dim_out"] else ())


def leaves(p, spec):
    """The block's parameter tensors in the kernel's operand order."""
    return [_leaf(p, path) for path in paths(spec)]


def block_params(w, spec):
    """The block's parameter tree from tensors in ``leaves`` order."""
    p: dict = {}
    for path, t in zip(paths(spec), w, strict=True):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return p


def geometry(spec, H: int, W: int) -> str:
    """The block's geometry class at an H x W input grid, the key of
    ``fused_block_trainable.launches_by_geometry``."""
    ws = spec["window_size"]
    win = "global" if ws == 0 else f"window {ws}"
    pool = ", q-pool" if spec["q_pool"] else ""
    return f"{H}x{W} {spec['dim']}->{spec['dim_out']} {win}{pool}"


def _table(ops):
    return (ctypes.c_void_p * len(ops))(*(
        None if t is None else t.data_ptr() for t in ops))


class _BlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec_key, q_stride, mlp_ratio, ops, *w):
        spec = dict(spec_key)
        out, x1 = hbk.fused_block({"_ops": ops}, x, spec, q_stride,
                                  mlp_ratio, save_residual=True)
        ctx.spec, ctx.mlp_ratio, ctx.ops = spec, mlp_ratio, ops
        ctx.save_for_backward(x, x1, *w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, x1, *w = ctx.saved_tensors
        spec, ops = ctx.spec, ctx.ops
        dev = x.device
        B, H, W, Cin = x.shape
        Cout, heads = spec["dim_out"], spec["num_heads"]
        hidden = int(Cout * ctx.mlp_ratio)
        wsh, wsw = hbk._window(spec, H, W)
        q_pool = int(bool(spec["q_pool"]))
        dy = dy.to(x.dtype).contiguous()
        lib = _lib()
        geo = (B, H, W, Cin, Cout, heads, hidden, wsh, wsw, q_pool)
        grads = torch.empty(sum(t.numel() for t in w), dtype=torch.float32,
                            device=dev)
        dx = torch.empty_like(x)
        ws = torch.empty(lib.hiera_bwd_workspace_bytes(
            *geo, int(ops[12] is not None)), dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.hiera_block_bwd(
                x.data_ptr(), x1.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                _table(ops), grads.data_ptr(), ws.data_ptr(), *geo, stream)
        kernel_build.check_launch(status, "hiera_block_bwd")
        fused_block_trainable.launches += 2
        by = fused_block_trainable.launches_by_geometry
        key = geometry(spec, H, W)
        by[key] = by.get(key, 0) + 2
        parts = torch.split(grads, [t.numel() for t in w])
        return (dx, None, None, None, None) + tuple(
            gr.view(t.shape).to(t.dtype) for gr, t in zip(parts, w))


def fused_block_trainable(p, x, spec, q_stride, mlp_ratio: float = 4.0):
    """Differentiable Hiera block, same contract as ``models/hiera.py``
    ``_block``: kernel #1 forward, kernel #6 backward on a CUDA tensor;
    the plain block (autograd) on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_block_trainable_plain(p, x, spec, q_stride, mlp_ratio)
    if not x.is_cuda:
        raise ValueError(f"fused_block_trainable: unsupported device "
                         f"{x.device}")
    if "bias" not in p["attn"]["qkv"]:
        raise ValueError("fused_block_trainable takes a qkv projection with "
                         "a bias")
    ops = p.get("_ops")
    if ops is None:
        with torch.no_grad():
            ops = hbk.pack(p, spec)
    return _BlockFn.apply(x.contiguous(), tuple(sorted(spec.items())),
                          tuple(q_stride), float(mlp_ratio), tuple(ops),
                          *leaves(p, spec))


fused_block_trainable.launches = 0
fused_block_trainable.launches_by_geometry = {}


def k_splits(M: int, N: int, K: int) -> int:
    """K chunks of a weight gradient [M, N] summed over K rows (the
    kernel's rule, ``csrc/hiera_block_bwd.cu`` ksplits); needs the built
    kernel."""
    return _lib().hiera_bwd_k_splits(M, N, K)


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("hiera_block_bwd")
    if not getattr(lib, "_sam2_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hiera_bwd_workspace_bytes.argtypes = [I] * 11
        lib.hiera_bwd_workspace_bytes.restype = ctypes.c_long
        lib.hiera_block_bwd.argtypes = ([P] * 4 + [ctypes.POINTER(P), P, P]
                                        + [I] * 10 + [P])
        lib.hiera_block_bwd.restype = I
        lib.hiera_bwd_k_splits.argtypes = [I, I, ctypes.c_long]
        lib.hiera_bwd_k_splits.restype = I
        lib._sam2_typed = True
    return lib
