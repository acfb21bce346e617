"""The trainable Hiera block: kernel #1 forward, and its backward as a
hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``sam2_video_tpu/ops/hiera_block_bwd.py``
``fused_block_trainable`` (Pallas ``_mlp_bwd_kernel`` and
``_attn_bwd_kernel``). Source: ``csrc/hiera_block_bwd.cu`` (the attention
it recomputes is shared with the forward in ``csrc/hiera_window.cuh``).

- The forward is kernel #1 (``ops/hiera_block_kernel.py``) with
  ``save_residual``: it keeps x1, the residual after attention, the one
  cut point from which both halves of the block can be recomputed.
- B1 recomputes LN2 -> W1 -> exact-erf GELU from x1 and gives dx1 and the
  LN2 / MLP gradients; B2 recomputes LN1, qkv, the shortcut and the
  attention (flash style: row statistics kept by the forward recompute,
  then a query-tiled dq pass and a key-tiled dk / dv pass over chunks in
  shared memory) and gives dx and the LN1 / qkv / proj / shortcut
  gradients. On H100 the products bound it: every one runs on mma.sync.
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
        M = x1.numel() // Cout
        dy = dy.to(x.dtype).contiguous()
        lib = _lib()
        table = _table(ops)
        g1 = torch.empty(2 * Cout + 2 * hidden * Cout + hidden + Cout,
                         dtype=torch.float32, device=dev)
        g2 = torch.empty(sum(t.numel() for t in w) - g1.numel(),
                         dtype=torch.float32, device=dev)
        dx1, dx = torch.empty_like(x1), torch.empty_like(x)
        ws1 = torch.empty(lib.hiera_bwd_mlp_workspace_bytes(M, Cout, hidden),
                          dtype=torch.uint8, device=dev)
        ws2 = torch.empty(lib.hiera_bwd_attn_workspace_bytes(
            B, H, W, Cin, Cout, heads, wsh, wsw, q_pool),
            dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.hiera_block_bwd_mlp(
                x1.data_ptr(), dy.data_ptr(), dx1.data_ptr(), table,
                g1.data_ptr(), ws1.data_ptr(), M, Cout, hidden, stream)
            kernel_build.check_launch(status, "hiera_block_bwd_mlp")
            del ws1
            status = lib.hiera_block_bwd_attn(
                x.data_ptr(), dx1.data_ptr(), dx.data_ptr(), table,
                g2.data_ptr(), ws2.data_ptr(), B, H, W, Cin, Cout, heads,
                wsh, wsw, q_pool, stream)
            kernel_build.check_launch(status, "hiera_block_bwd_attn")
        fused_block_trainable.launches += 2
        by = fused_block_trainable.launches_by_geometry
        key = geometry(spec, H, W)
        by[key] = by.get(key, 0) + 2
        # g1: ln2 w, b, W1, b1, W2, b2; g2: ln1 w, b, Wqkv, bqkv, Wproj,
        # bproj[, Wsc, bsc] -- the leaves' order with g2 first
        parts2 = torch.split(g2, [t.numel() for t in w[:6]]
                             + [t.numel() for t in w[12:]])
        parts1 = torch.split(g1, [t.numel() for t in w[6:12]])
        grads = list(parts2[:6]) + list(parts1) + list(parts2[6:])
        return (dx, None, None, None, None) + tuple(
            gr.view(t.shape).to(t.dtype) for gr, t in zip(grads, w))


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


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("hiera_block_bwd")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        T = ctypes.POINTER(ctypes.c_void_p)
        lib.hiera_bwd_mlp_workspace_bytes.argtypes = [L, I, I]
        lib.hiera_bwd_mlp_workspace_bytes.restype = L
        lib.hiera_block_bwd_mlp.argtypes = [P, P, P, T, P, P, L, I, I, P]
        lib.hiera_block_bwd_mlp.restype = I
        lib.hiera_bwd_attn_workspace_bytes.argtypes = [I] * 9
        lib.hiera_bwd_attn_workspace_bytes.restype = L
        lib.hiera_block_bwd_attn.argtypes = [P, P, P, T, P, P] + [I] * 9 + [P]
        lib.hiera_block_bwd_attn.restype = I
        lib._sam2_typed = True
    return lib
