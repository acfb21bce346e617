"""Memory cross-attention with the key projection and RoPE fused in, as a
hand-written CUDA kernel for Hopper, forward and backward.

Replaces the TPU kernel ``sam2_video_tpu/ops/flash_attention.py``
``flash_attention_kproj`` (Pallas ``_fwd_kproj_kernel`` and the merged
``_bwd_kproj_kernel``). Source: ``csrc/flash_kproj.cu``.

- What it computes: k = RoPE(kin Wk^T + bk) per key tile, never stored
  (the leading ``num_spatial`` keys rotate by the axial table of one slot,
  tiled per slot; the trailing object-pointer keys are not rotated); s =
  (q / sqrt(d)) k^T + key bias; softmax; o = p v against the raw 64-wide
  memory (the v-commute). f32 inside, one rounding at the output, as the
  TPU kernel: Wk and bk are first cast to q's dtype, as its wrapper does.
- On H100 (8 objects, 576 queries, 580-4068 keys) the attention products
  bound it; the kernel keeps every product on the tensor cores and feeds
  the f32 values (rotated k, probabilities, score gradients) as a bf16
  high part plus a bf16 remainder, so it stays within ~2^-16 of f32.
- The TPU packing tricks are layout and are not reproduced: no 1.0 lane
  carrying bk inside an augmented Wk, no 128-lane padding of v and of the
  output, no padding of Lk to a multiple of 256 (the last key tile is
  masked). The output is [..., Lq, kv], kv = 64.
- Backward: a dq pass over key tiles and a dkin / dv pass over query tiles
  whose dWk / dbk are per-tile f32 partials added by a last pass in a fixed
  order (the TPU kernel summed them in one VMEM block across its ordered
  grid). dWk and dbk are f32; they come back in the dtype Wk and bk had
  inside the function (q's), as in the JAX package.

``flash_attention_kproj`` takes the plain version for CPU tensors and runs
the kernel for CUDA tensors (or raises). ``flash_attention_kproj.launches``
counts forward launches, ``.backward_launches`` backward ones.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernel_build
from .position_encoding import axial_rope_table_half

KERNEL_DIM = 256    # q / k width the kernel is compiled for
KERNEL_KV = 64      # kin / v width


def kproj_rope_tables(dim: int, grid_wh, theta: float, dtype: torch.dtype,
                      device):
    """(cos, sin), each [gw * gh, dim // 2] float32: the axial table of one
    slot in the compact half layout, rounded through ``dtype`` (the TPU
    wrapper streams the tables in q's dtype)."""
    gw, gh = grid_wh
    cos, sin = axial_rope_table_half(dim, gw, gh, theta, device=device)
    h = dim // 2
    return (cos[:, :h].to(dtype).float().contiguous(),
            sin[:, :h].to(dtype).float().contiguous())


def flash_attention_kproj_plain(q, kin, v, wk_weight, wk_bias, key_bias,
                                num_spatial: int, grid_wh,
                                theta: float = 10000.0):
    """The kernel's function in plain PyTorch, on its walk: f32 inside
    (not ``ops/attention.py`` ``sdpa``, which rounds p before PV), one
    rounding at the output."""
    cdt = q.dtype
    D = q.shape[-1]
    Lk = kin.shape[-2]
    cos_t, sin_t = kproj_rope_tables(D, grid_wh, theta, cdt, q.device)
    reps = num_spatial // cos_t.shape[0]
    tail = Lk - num_spatial
    cos = torch.cat([cos_t.repeat(reps, 1),
                     cos_t.new_ones((tail, D // 2))], 0)
    sin = torch.cat([sin_t.repeat(reps, 1),
                     sin_t.new_zeros((tail, D // 2))], 0)
    wk = wk_weight.to(cdt).float()
    bk = wk_bias.to(cdt).float()
    kpre = torch.matmul(kin.float(), wk.t()) + bk
    k1, k2 = kpre[..., :D // 2], kpre[..., D // 2:]
    k = torch.cat([k1 * cos - k2 * sin, k2 * cos + k1 * sin], dim=-1)
    s = torch.matmul(q.float() * (1.0 / math.sqrt(D)), k.transpose(-1, -2))
    if key_bias is not None:
        s = s + key_bias.float()[..., None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(cdt)


class _KprojFn(torch.autograd.Function):
    """q [BH, Lq, 256], kin / v [BH, Lk, 64], wk [256, 64], bk [256] (all
    bf16); bias [1 or BH, Lk] f32 or None; cos / sin [HW, 128] f32."""

    @staticmethod
    def forward(ctx, q, kin, v, wk, bk, bias, cos, sin, num_spatial, HW):
        BH, Lq, _ = q.shape
        Lk = kin.shape[1]
        dev = q.device
        out = torch.empty((BH, Lq, KERNEL_KV), dtype=q.dtype, device=dev)
        lse = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
        bkf = bk.float().contiguous()
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.kproj_fwd(
                q.data_ptr(), kin.data_ptr(), v.data_ptr(), wk.data_ptr(),
                bkf.data_ptr(), _ptr(bias), _bias_stride(bias), cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, Lq, Lk,
                num_spatial, HW, stream)
        kernel_build.check_launch(status, "kproj_fwd")
        flash_attention_kproj.launches += 1
        ctx.save_for_backward(q, kin, v, wk, bk, bias, cos, sin, out, lse)
        ctx.geometry = (num_spatial, HW)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kin, v, wk, bk, bias, cos, sin, out, lse = ctx.saved_tensors
        num_spatial, HW = ctx.geometry
        BH, Lq, D = q.shape
        Lk = kin.shape[1]
        dev = q.device
        dout = dout.to(q.dtype).contiguous()
        dq = torch.empty_like(q)
        dkin = torch.empty_like(kin)
        dv = torch.empty_like(v)
        dw = torch.empty(D * KERNEL_KV + D, dtype=torch.float32, device=dev)
        bkf = bk.float().contiguous()
        lib = _lib()
        ws = torch.empty(lib.kproj_bwd_workspace_bytes(BH, Lq, Lk),
                         dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.kproj_bwd(
                q.data_ptr(), kin.data_ptr(), v.data_ptr(), wk.data_ptr(),
                bkf.data_ptr(), _ptr(bias), _bias_stride(bias), cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), lse.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dkin.data_ptr(),
                dv.data_ptr(), dw.data_ptr(), ws.data_ptr(), BH, Lq, Lk,
                num_spatial, HW, stream)
        kernel_build.check_launch(status, "kproj_bwd")
        flash_attention_kproj.backward_launches += 1
        dwk = dw[:D * KERNEL_KV].view(D, KERNEL_KV).to(wk.dtype)
        dbk = dw[D * KERNEL_KV:].to(bk.dtype)
        return dq, dkin, dv, dwk, dbk, None, None, None, None, None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bias_stride(bias) -> int:
    return 0 if bias is None or bias.shape[0] == 1 else bias.shape[1]


def flash_attention_kproj(q, kin, v, wk_weight, wk_bias, key_bias,
                          num_spatial: int, grid_wh, theta: float = 10000.0):
    """Memory cross-attention with the key projection and RoPE fused.

    q [..., Lq, 256] (projected and rotated); kin [..., Lk, 64] (memory +
    its positional encoding); v [..., Lk, 64] (the raw memory); wk_weight
    [256, 64], wk_bias [256] (rows de-interleave-permuted); key_bias [Lk] or
    [..., Lk] additive float32, or None; grid_wh (w, h) of one slot.
    Returns [..., Lq, 64] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_kproj_plain(q, kin, v, wk_weight, wk_bias,
                                           key_bias, num_spatial, grid_wh,
                                           theta)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_kproj: unsupported device "
                         f"{q.device}")
    for name, t in (("q", q), ("kin", kin), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_kproj kernel takes bfloat16 "
                            f"{name}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_kproj: {name} on {t.device}")
    *lead, Lq, D = q.shape
    Lk, kv = kin.shape[-2:]
    gw, gh = grid_wh
    if D != KERNEL_DIM or kv != KERNEL_KV or tuple(v.shape[-2:]) != (Lk, kv):
        raise ValueError(f"flash_attention_kproj kernel takes q [..., Lq, "
                         f"{KERNEL_DIM}] and kin / v [..., Lk, {KERNEL_KV}], "
                         f"got {tuple(q.shape)}, {tuple(kin.shape)}, "
                         f"{tuple(v.shape)}")
    if num_spatial % (gw * gh) or num_spatial > Lk:
        raise ValueError("num_spatial must be a multiple of the slot size "
                         "and at most Lk")
    BH = math.prod(lead)
    q3 = q.reshape(BH, Lq, D).contiguous()
    kin3 = kin.reshape(BH, Lk, kv).contiguous()
    v3 = v.reshape(BH, Lk, kv).contiguous()
    bias = None
    if key_bias is not None:
        kb = key_bias.float()
        bias = (kb.reshape(1, Lk) if kb.ndim == 1 else
                kb.expand(*lead, Lk).reshape(BH, Lk)).contiguous()
    cos, sin = kproj_rope_tables(D, grid_wh, theta, q.dtype, q.device)
    out = _KprojFn.apply(q3, kin3, v3, wk_weight.to(q.dtype).contiguous(),
                         wk_bias.to(q.dtype), bias, cos, sin, num_spatial,
                         gw * gh)
    return out.reshape(*lead, Lq, kv)


flash_attention_kproj.launches = 0
flash_attention_kproj.backward_launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("flash_kproj")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.kproj_fwd.argtypes = [P] * 6 + [L] + [P] * 4 + [I] * 5 + [P]
        lib.kproj_fwd.restype = I
        lib.kproj_bwd.argtypes = ([P] * 6 + [L] + [P] * 10 + [I] * 5 + [P])
        lib.kproj_bwd.restype = I
        lib.kproj_bwd_workspace_bytes.argtypes = [I, I, I]
        lib.kproj_bwd_workspace_bytes.restype = L
        lib._sam2_typed = True
    return lib
