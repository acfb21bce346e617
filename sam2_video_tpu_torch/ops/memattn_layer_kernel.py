"""The memory-attention layer's two fused blocks as hand-written CUDA
kernels for Hopper, forward and backward.

Replaces the TPU kernels of ``sam2_video_tpu/ops/memattn_layer_kernel.py``
(source: ``csrc/memattn_layer.cu``):

- ``fused_self_block`` (Pallas ``_self_fwd_kernel`` / ``_self_bwd_kernel``):
  LN1 -> q, k, v -> RoPE(q, k) -> dense single-head L x L attention (f32
  softmax, p cast to the compute dtype before PV) -> out-proj -> +residual;
  plus the cross-attention query LN2 -> q-proj -> RoPE (``q3``, the input
  of ``flash_attention_kproj``).
- ``fused_tail_block`` (Pallas ``_tail_fwd_kernel`` / ``_tail_bwd_kernel``):
  v-proj on the cross-attention output -> out-proj -> +residual -> LN3 ->
  linear1 -> ReLU -> linear2 -> +residual.

On H100 (8 objects, 576 tokens, d 256, hidden 2048) the products bound
both blocks. Every product is a wgmma on 128-byte-swizzled tiles staged by
cp.async (``csrc/sm90.cuh``, ``csrc/sm90_gemm.cuh``): row chains (64 rows
x all 256 columns per block: LN1 -> q, k, v with RoPE; o -> out-proj ->
LN2 -> q-proj; v-proj -> out-proj -> LN3), a grouped GEMM for the MLP and
the backward products, and flash kernels for the L x L self-attention (a
two-pass exact softmax forward; dq and dk / dv passes), so the scores
never reach device memory. The backward passes recompute the forward from
the block inputs, as the TPU kernels do. The TPU backward sums weight
gradients across objects in one VMEM block (its grid runs in order); here
each weight gradient is one GEMM over the rows of all objects cut into a
fixed number of K chunks (``k_splits``), the bias gradients are column
sums inside the same GEMMs, and a last kernel adds the f32 partials in a
fixed order: the same bits twice, no float atomics. The forward packs the
weights (bf16 matrices, f32 vectors) into one buffer in one launch and
keeps it for the backward. Weight and bias gradients are float32. The
kernels round once per fused epilogue where the plain versions round after
every op: a few bf16 ulps, which chip_smoke.py bounds at 2e-2 of the
output scale.

Any token count: the wrappers pad L to a multiple of 32 (``ROW_MULTIPLE``)
with zero rows; the self block masks the pad keys in its softmax, the pad
rows' outputs are dropped, and their zero cotangents add nothing to any
gradient (JAX's fused path needs L % 8 and runs plain otherwise; the
port's kernels run at every L, e.g. 36 tokens at 96 px, 784 at 448 px).

The TPU tail consumed the 128-lane padded flash output with a zero-column
augmented v-proj weight; here the cross-attention output is 64 wide and
the v-proj weight is used as it is.

Both wrappers take the plain version for CPU tensors and run the kernels
for CUDA tensors (or raise). ``.launches`` counts forward launches,
``.backward_launches`` backward ones.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import common as nn
from . import kernel_build
from .attention import sdpa
from .position_encoding import apply_rope_half

D_MODEL = 256
ROW_MULTIPLE = 32   # tokens per object the wrappers pad to


# ---------------------------------------------------------------------------
# Plain versions (the JAX kernels' dtype walk)
# ---------------------------------------------------------------------------


def fused_self_block_plain(p_self, p_qc, ln1, ln2, x, cos, sin):
    """p_self {"q", "k", "v", "out"} linears (q, k rows de-interleave-
    permuted), p_qc the cross-attention q-proj (permuted), x [N, L, D],
    cos / sin [L, D] float32. Returns (out, q3)."""
    xn = nn.layer_norm(ln1, x)
    q = apply_rope_half(nn.linear(p_self["q"], xn), cos, sin)
    k = apply_rope_half(nn.linear(p_self["k"], xn), cos, sin)
    v = nn.linear(p_self["v"], xn)
    out = x + nn.linear(p_self["out"], sdpa(q, k, v))
    y2 = nn.layer_norm(ln2, out)
    return out, apply_rope_half(nn.linear(p_qc, y2), cos, sin)


def fused_tail_block_plain(p_v, p_out, ln3, p_l1, p_l2, y, a):
    """y [N, L, D] residual stream, a [N, L, kv] cross-attention output
    (before the v-projection). Returns [N, L, D]."""
    z = y + nn.linear(p_out, nn.linear(p_v, a))
    h = nn.layer_norm(ln3, z)
    return z + nn.linear(p_l2, F.relu(nn.linear(p_l1, h)))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _f32(t):
    return t.float().contiguous()


def _leaves(w):
    """The leaves as the kernels read them (f32 or bf16, contiguous), their
    pointer table and the mask of the bf16 ones (bit i: leaf i)."""
    w = [t if t.dtype in (torch.float32, torch.bfloat16) and
         t.is_contiguous() else _f32(t) for t in w]
    table = (ctypes.c_void_p * len(w))(*(t.data_ptr() for t in w))
    mask = sum(1 << i for i, t in enumerate(w) if t.dtype == torch.bfloat16)
    return w, table, mask


def _workspace(nbytes: int, dev):
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _pad_rows(t, L: int):
    """t [N, L0, C] padded with zero rows to [N, L, C]."""
    return F.pad(t, (0, 0, 0, L - t.shape[1])) if L != t.shape[1] else t


def k_splits(M: int, N: int, K: int) -> int:
    """K chunks of a weight gradient [M, N] summed over K rows (the
    kernels' rule, ``csrc/sm90_gemm.cuh`` gm_k_splits); needs the built
    library."""
    return _lib().memattn_k_splits(M, N, K)


class _SelfFn(torch.autograd.Function):
    """x [N, L, 256] (L % ROW_MULTIPLE == 0) of which the first Lv tokens
    are real, cos / sin [L, 256]."""

    @staticmethod
    def forward(ctx, x, cos, sin, Lv, *w):
        N, L, D = x.shape
        dev = x.device
        leaves, table, mask = _leaves(w)
        out, q3 = torch.empty_like(x), torch.empty_like(x)
        lib = _lib()
        packed = _workspace(lib.memattn_self_pack_bytes(), dev)
        ws = _workspace(lib.memattn_self_workspace_bytes(N, L, 0), dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.memattn_self_fwd(
                x.data_ptr(), table, mask, packed.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), q3.data_ptr(), ws.data_ptr(),
                N, L, Lv, stream)
        kernel_build.check_launch(status, "memattn_self_fwd")
        fused_self_block.launches += 1
        ctx.save_for_backward(x, cos, sin, packed)
        ctx.Lv = Lv
        ctx.leaf_dtypes = [t.dtype for t in w]
        return out, q3

    @staticmethod
    def backward(ctx, dout, dq3):
        x, cos, sin, packed = ctx.saved_tensors
        N, L, D = x.shape
        dev = x.device
        dout = dout.to(x.dtype).contiguous()
        dq3 = dq3.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        g = torch.empty(5 * D * D + 9 * D, dtype=torch.float32, device=dev)
        lib = _lib()
        ws = _workspace(lib.memattn_self_workspace_bytes(N, L, 1), dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.memattn_self_bwd(
                x.data_ptr(), packed.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), dout.data_ptr(), dq3.data_ptr(),
                dx.data_ptr(), g.data_ptr(), ws.data_ptr(), N, L, ctx.Lv,
                stream)
        kernel_build.check_launch(status, "memattn_self_bwd")
        fused_self_block.backward_launches += 1
        d = D_MODEL
        sizes = [d, d, 3 * d * d, 3 * d, d * d, d, d, d, d * d, d]
        (dln1w, dln1b, dwqkv, dbqkv, dwo, dbo, dln2w, dln2b, dwqc,
         dbqc) = torch.split(g, sizes)
        dwq, dwk, dwv = dwqkv.view(3 * d, d).split(d)
        dbq, dbk, dbv = dbqkv.split(d)
        grads = (dln1w, dln1b, dwq, dbq, dwk, dbk, dwv, dbv,
                 dwo.view(d, d), dbo, dln2w, dln2b, dwqc.view(d, d), dbqc)
        return (dx, None, None, None) + tuple(
            gr.to(dt) for gr, dt in zip(grads, ctx.leaf_dtypes))


def fused_self_block(p_self, p_qc, ln1, ln2, x, cos, sin):
    """Differentiable fused self-attention block (same contract as
    ``fused_self_block_plain``)."""
    if x.device.type == "cpu":
        return fused_self_block_plain(p_self, p_qc, ln1, ln2, x, cos, sin)
    if not x.is_cuda:
        raise ValueError(f"fused_self_block: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_self_block kernel takes bfloat16, got "
                        f"{x.dtype}")
    *lead, L, D = x.shape
    if D != D_MODEL:
        raise ValueError(f"fused_self_block kernel takes [..., L, "
                         f"{D_MODEL}], got {tuple(x.shape)}")
    if tuple(cos.shape) != (L, D) or tuple(sin.shape) != (L, D):
        raise ValueError("cos / sin must be [L, D] tables")
    w = (ln1["weight"], ln1["bias"], p_self["q"]["weight"],
         p_self["q"]["bias"], p_self["k"]["weight"], p_self["k"]["bias"],
         p_self["v"]["weight"], p_self["v"]["bias"],
         p_self["out"]["weight"], p_self["out"]["bias"], ln2["weight"],
         ln2["bias"], p_qc["weight"], p_qc["bias"])
    Lp = -(-L // ROW_MULTIPLE) * ROW_MULTIPLE
    x3 = _pad_rows(x.reshape(-1, L, D), Lp).contiguous()
    cos, sin = (_pad_rows(_f32(t)[None], Lp)[0].contiguous()
                for t in (cos, sin))
    out, q3 = _SelfFn.apply(x3, cos, sin, L, *w)
    return (out[:, :L].reshape(x.shape), q3[:, :L].reshape(x.shape))


fused_self_block.launches = 0
fused_self_block.backward_launches = 0


class _TailFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, a, *w):
        N, L, _ = y.shape
        KV, HID = a.shape[-1], w[6].shape[0]
        dev = y.device
        leaves, table, mask = _leaves(w)
        out = torch.empty_like(y)
        lib = _lib()
        packed = _workspace(lib.memattn_tail_pack_bytes(KV, HID), dev)
        ws = _workspace(lib.memattn_tail_workspace_bytes(N, L, KV, HID, 0),
                        dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.memattn_tail_fwd(
                y.data_ptr(), a.data_ptr(), table, mask, packed.data_ptr(),
                out.data_ptr(), ws.data_ptr(), N, L, KV, HID, stream)
        kernel_build.check_launch(status, "memattn_tail_fwd")
        fused_tail_block.launches += 1
        ctx.save_for_backward(y, a, packed)
        ctx.leaves = [(t.shape, t.dtype) for t in w]
        return out

    @staticmethod
    def backward(ctx, g):
        y, a, packed = ctx.saved_tensors
        N, L, D = y.shape
        KV, HID = a.shape[-1], ctx.leaves[6][0][0]
        dev = y.device
        g = g.to(y.dtype).contiguous()
        dy, da = torch.empty_like(y), torch.empty_like(a)
        lib = _lib()
        grads = torch.empty(lib.memattn_tail_grad_floats(KV, HID),
                            dtype=torch.float32, device=dev)
        ws = _workspace(lib.memattn_tail_workspace_bytes(N, L, KV, HID, 1),
                        dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.memattn_tail_bwd(
                y.data_ptr(), a.data_ptr(), packed.data_ptr(), g.data_ptr(),
                dy.data_ptr(), da.data_ptr(), grads.data_ptr(),
                ws.data_ptr(), N, L, KV, HID, stream)
        kernel_build.check_launch(status, "memattn_tail_bwd")
        fused_tail_block.backward_launches += 1
        parts = torch.split(grads, [shape.numel() for shape, _ in ctx.leaves])
        return (dy, da) + tuple(gr.view(shape).to(dt) for gr, (shape, dt)
                                in zip(parts, ctx.leaves))


def fused_tail_block(p_v, p_out, ln3, p_l1, p_l2, y, a):
    """Differentiable fused tail block (same contract as
    ``fused_tail_block_plain``)."""
    if y.device.type == "cpu":
        return fused_tail_block_plain(p_v, p_out, ln3, p_l1, p_l2, y, a)
    if not y.is_cuda:
        raise ValueError(f"fused_tail_block: unsupported device {y.device}")
    for name, t in (("y", y), ("a", a)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_tail_block kernel takes bfloat16 {name},"
                            f" got {t.dtype}")
    *lead, L, D = y.shape
    KV, HID = a.shape[-1], p_l1["weight"].shape[0]
    if (D != D_MODEL or KV % 64 or KV > D_MODEL or HID % 64 or
            tuple(a.shape[:-1]) != tuple(y.shape[:-1])):
        raise ValueError(f"fused_tail_block kernel takes y [..., L, "
                         f"{D_MODEL}] and a [..., L, kv] with kv in 64, 128,"
                         f" 192, 256 and a hidden width % 64 == 0, got "
                         f"{tuple(y.shape)}, {tuple(a.shape)}, hidden {HID}")
    w = (p_v["weight"], p_v["bias"], p_out["weight"], p_out["bias"],
         ln3["weight"], ln3["bias"], p_l1["weight"], p_l1["bias"],
         p_l2["weight"], p_l2["bias"])
    Lp = -(-L // ROW_MULTIPLE) * ROW_MULTIPLE
    out = _TailFn.apply(_pad_rows(y.reshape(-1, L, D), Lp).contiguous(),
                        _pad_rows(a.reshape(-1, L, KV), Lp).contiguous(), *w)
    return out[:, :L].reshape(y.shape)


fused_tail_block.launches = 0
fused_tail_block.backward_launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("memattn_layer")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        T = ctypes.POINTER(ctypes.c_void_p)
        lib.memattn_k_splits.argtypes = [I, I, I]
        lib.memattn_k_splits.restype = I
        lib.memattn_self_pack_bytes.argtypes = []
        lib.memattn_self_pack_bytes.restype = L
        lib.memattn_self_workspace_bytes.argtypes = [I, I, I]
        lib.memattn_self_workspace_bytes.restype = L
        lib.memattn_self_fwd.argtypes = [P, T, I] + [P] * 6 + [I] * 3 + [P]
        lib.memattn_self_fwd.restype = I
        lib.memattn_self_bwd.argtypes = [P] * 9 + [I] * 3 + [P]
        lib.memattn_self_bwd.restype = I
        lib.memattn_tail_pack_bytes.argtypes = [I, I]
        lib.memattn_tail_pack_bytes.restype = L
        lib.memattn_tail_grad_floats.argtypes = [I, I]
        lib.memattn_tail_grad_floats.restype = L
        lib.memattn_tail_workspace_bytes.argtypes = [I] * 5
        lib.memattn_tail_workspace_bytes.restype = L
        lib.memattn_tail_fwd.argtypes = [P, P, T, I, P, P, P] + [I] * 4 + [P]
        lib.memattn_tail_fwd.restype = I
        lib.memattn_tail_bwd.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.memattn_tail_bwd.restype = I
        lib._sam2_typed = True
    return lib
