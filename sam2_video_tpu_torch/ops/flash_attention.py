"""Memory cross-attention kernels, hand-written CUDA for Hopper, forward
and backward: the counterparts of the two TPU kernels of
``sam2_video_tpu/ops/flash_attention.py``.

``flash_attention_kproj`` replaces ``flash_attention_kproj`` (Pallas
``_fwd_kproj_kernel`` and the merged ``_bwd_kproj_kernel``). Source:
``csrc/flash_kproj.cu``.

- What it computes: k = RoPE(kin Wk^T + bk) per key tile, never stored
  (the leading ``num_spatial`` keys rotate by the axial table of one slot,
  tiled per slot; the trailing object-pointer keys are not rotated); s =
  (q / sqrt(d)) k^T + key bias; softmax; o = p v against the raw 64-wide
  memory (the v-commute). f32 inside, one rounding at the output, as the
  TPU kernel: Wk and bk are first cast to q's dtype, as its wrapper does.
- On H100 (8 objects, 576 queries, 580-4068 keys) the tensor cores bound
  it: every product, the key projection included, is a wgmma fed by a
  two-stage cp.async ring of 128-byte-swizzled tiles; the f32 values that
  feed a product (rotated k, probabilities, score gradients, the
  projection's gradient) go in as a bf16 high part plus a bf16 remainder,
  so it stays within ~2^-16 of f32. A block of ``KPROJ_WARPGROUPS``
  warpgroups (64 queries each; the dq pass one above 34 x 34 slots)
  shares each projected key tile, and the keys of the forward and of the
  dq pass are split across blocks (``kproj_plan``) when the query blocks
  alone do not fill the card twice.
- The TPU packing tricks are layout and are not reproduced: no 1.0 lane
  carrying bk inside an augmented Wk, no 128-lane padding of v and of the
  output, no padding of Lk to a multiple of 256 (the last key tile is
  masked). The output is [..., Lq, kv], kv = 64. The RoPE factors go to
  the kernel as one row per slot column x and one per slot row y
  (``kproj_rope_axes``), the values of the plain version's table.
- Backward: a dq pass over key tiles (each tile projected once per block,
  all 256 columns of dq in one warpgroup), a dkin / dv pass over query
  tiles that stores the projection's gradient dpre, and one GEMM over the
  stored dpre for dWk / dbk whose per-block f32 partials are added in a
  fixed order (the TPU kernel summed them in one VMEM block across its
  ordered grid). No float atomics. dWk and dbk are f32; they come back in
  the dtype Wk and bk had inside the function (q's), as in the JAX package.

``flash_attention`` replaces the generic ``flash_attention`` (Pallas
``_fwd_kernel`` and the merged dq/dk/dv ``_bwd_kernel``). Source:
``csrc/flash_attention.cu`` (Hopper helpers in ``csrc/sm90.cuh``).

- What it computes: softmax(q k^T / sqrt(D) + key_bias) v over [..., L, D]
  heads, with an additive float32 key bias and the row logsumexp kept for
  the backward; f32 statistics, an online softmax over 64-key tiles, the
  probabilities and score gradients fed to the tensor cores as bf16 hi +
  lo, one rounding at each output. The key bias gets no gradient (the
  TPU kernel returns zeros for it).
- Head widths D and value widths Dv of 64, 128 or 256, any Lq and Lk (the
  last query and key tiles are masked): no padding of the keys to a
  multiple of 256, no padding of v to 128 lanes, no Lq limit.
- On H100 the tensor cores bound it: every product is a wgmma fed from a
  two-stage cp.async ring of 128-byte-swizzled tiles, and the keys of the
  forward and of the dq pass are split across blocks (``split_tiles``)
  when the query tiles alone do not fill the card twice; a combine merges
  the splits in split order.
- Backward: a dq pass over key tiles and a dk / dv pass over query tiles
  (the TPU kernel's single ordered sweep carried dq in VMEM), no float
  atomics, so two runs give the same bits.

Each wrapper takes its plain version for CPU tensors and runs its kernel
for CUDA tensors (or raises). ``.launches`` counts forward launches,
``.backward_launches`` backward ones.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import kernel_build
from .position_encoding import axial_rope_table_half

KERNEL_DIM = 256    # q / k width the kernel is compiled for
KERNEL_KV = 64      # kin / v width
KPROJ_MAX_ROPE_ROWS = 128   # w + h of the slot grids whose RoPE rows the
                            # kernel keeps in shared memory (64 x 64: 1024
                            # px); larger grids read the table in place
KPROJ_WARPGROUPS = 2        # warpgroups of 64 queries per forward / dq block
KPROJ_DQ_MAX_ROPE_ROWS = 68  # w + h of the slot grid for two in a dq block
KPROJ_MIN_SPLIT_TILES = 3   # key tiles a split of #3 runs at least
KPROJ_SPLIT_COST = 0.25     # a split's share of the combines, in key tiles


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


def kproj_rope_axes(cos: torch.Tensor, sin: torch.Tensor, gw: int,
                    gh: int) -> torch.Tensor:
    """The kernel's RoPE factors, [gw + gh, 128] bf16, from the slot table
    (``kproj_rope_tables``, [gw * gh, dim // 2]): pairs 0..63 rotate by the
    x position alone and pairs 64..127 by the y position alone, so row x
    holds (cos, sin) of pairs 0..63 at position x of the first slot row
    and row gw + y those of pairs 64..127 at the start of slot row y. The
    values are bf16 already (the tables are rounded through q's dtype)."""
    q4 = cos.shape[1] // 2
    xs = torch.cat([cos[:gw, :q4], sin[:gw, :q4]], 1)
    ys = torch.cat([cos[::gw, q4:], sin[::gw, q4:]], 1)
    return torch.cat([xs, ys], 0).to(torch.bfloat16).contiguous()


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
    bf16); bias [1 or BH, Lk] f32 or None; rope [gw + gh, 128] bf16
    (``kproj_rope_axes``); geometry (num_spatial, gw, gh)."""

    @staticmethod
    def forward(ctx, q, kin, v, wk, bk, bias, rope, geometry):
        num_spatial, gw, gh = geometry
        BH, Lq, _ = q.shape
        Lk = kin.shape[1]
        dev = q.device
        plan = kproj_plan(BH, Lq, Lk, (gw, gh), _sms(dev))
        S, tps = plan.fwd
        out = torch.empty((BH, Lq, KERNEL_KV), dtype=q.dtype, device=dev)
        lse = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
        part = (torch.empty(S * BH * Lq * (KERNEL_KV + 2),
                            dtype=torch.float32, device=dev)
                if S > 1 else None)
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.kproj_fwd(
                q.data_ptr(), kin.data_ptr(), v.data_ptr(), wk.data_ptr(),
                bk.data_ptr(), _ptr(bias), _bias_stride(bias),
                rope.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(part),
                BH, Lq, Lk, num_spatial, gw * gh, gw, gh, tps, stream)
        kernel_build.check_launch(status, "kproj_fwd")
        flash_attention_kproj.launches += 1
        ctx.save_for_backward(q, kin, v, wk, bk, bias, rope, out, lse)
        ctx.geometry = geometry
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kin, v, wk, bk, bias, rope, out, lse = ctx.saved_tensors
        num_spatial, gw, gh = ctx.geometry
        BH, Lq, D = q.shape
        Lk = kin.shape[1]
        dev = q.device
        plan = kproj_plan(BH, Lq, Lk, (gw, gh), _sms(dev))
        (S, tps), (dw_blocks, dw_tiles) = plan.dq, plan.dw
        dout = dout.to(q.dtype).contiguous()
        dq = torch.empty_like(q)
        dkin = torch.empty_like(kin)
        dv = torch.empty_like(v)
        nw = D * KERNEL_KV + D
        dw = torch.empty(nw, dtype=torch.float32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        delta = torch.empty(BH * Lq, **f32)
        dq_part = torch.empty(S * BH * Lq * D, **f32) if S > 1 else None
        dpre = torch.empty(2 * BH * Lk * D, dtype=torch.bfloat16, device=dev)
        dw_part = torch.empty(dw_blocks * nw, **f32)
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.kproj_bwd(
                q.data_ptr(), kin.data_ptr(), v.data_ptr(), wk.data_ptr(),
                bk.data_ptr(), _ptr(bias), _bias_stride(bias),
                rope.data_ptr(), out.data_ptr(), lse.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dkin.data_ptr(),
                dv.data_ptr(), dw.data_ptr(), delta.data_ptr(),
                _ptr(dq_part), dpre.data_ptr(), dw_part.data_ptr(), BH, Lq,
                Lk, num_spatial, gw * gh, gw, gh, plan.dq_warpgroups, tps,
                dw_tiles, stream)
        kernel_build.check_launch(status, "kproj_bwd")
        flash_attention_kproj.backward_launches += 1
        dwk = dw[:D * KERNEL_KV].view(D, KERNEL_KV).to(wk.dtype)
        dbk = dw[D * KERNEL_KV:].to(bk.dtype)
        return dq, dkin, dv, dwk, dbk, None, None, None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bias_stride(bias) -> int:
    return 0 if bias is None or bias.shape[0] == 1 else bias.shape[1]


@functools.lru_cache(maxsize=16)
def _rope_axes(D, gw, gh, theta, dtype, device) -> torch.Tensor:
    """``kproj_rope_axes`` of a slot grid, made once per grid, dtype and
    device (a few small host and device operations each call otherwise)."""
    cos, sin = kproj_rope_tables(D, (gw, gh), theta, dtype, device)
    return kproj_rope_axes(cos, sin, gw, gh)


def flash_attention_kproj(q, kin, v, wk_weight, wk_bias, key_bias,
                          num_spatial: int, grid_wh, theta: float = 10000.0):
    """Memory cross-attention with the key projection and RoPE fused.

    q [..., Lq, 256] (projected and rotated); kin [..., Lk, 64] (memory +
    its positional encoding); v [..., Lk, 64] (the raw memory); wk_weight
    [256, 64], wk_bias [256] (rows de-interleave-permuted); key_bias [Lk] or
    [..., Lk] additive float32, or None; grid_wh (w, h) of one slot, any
    size (the kernel keeps the w + h RoPE rows in shared memory up to
    ``KPROJ_MAX_ROPE_ROWS``, 64 x 64 slots of 1024 px images, and reads
    them from device memory above). Returns [..., Lq, 64] in q's dtype."""
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
    out = _KprojFn.apply(q3, kin3, v3, wk_weight.to(q.dtype).contiguous(),
                         wk_bias.to(q.dtype).contiguous(), bias,
                         _rope_axes(D, gw, gh, theta, q.dtype, q.device),
                         (num_spatial, gw, gh))
    return out.reshape(*lead, Lq, kv)


flash_attention_kproj.launches = 0
flash_attention_kproj.backward_launches = 0


FLASH_WIDTHS = (64, 128, 256)   # head and value widths of the kernel


def flash_attention_plain(q, k, v, key_bias=None):
    """The kernel's function in plain PyTorch: f32 logits, softmax and PV
    (not ``ops/attention.py`` ``sdpa``, which rounds p before PV), one
    rounding at the output."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if key_bias is not None:
        s = s + key_bias.float()[..., None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


TILE = 64             # queries / keys per tile of kernel #7
MIN_SPLIT_TILES = 8   # key tiles a split runs at least


def split_tiles(blocks: int, Lk: int, per_sm: int, sms: int,
                min_tiles: int = MIN_SPLIT_TILES,
                split_cost: float = 0.0) -> int:
    """Key tiles per split of kernel #7's (and #3's) forward and dq pass,
    for a grid of ``blocks`` blocks (query tiles x batch-heads x column
    blocks) before the split, on ``sms`` SMs that hold ``per_sm`` blocks
    each. The keys stay whole (one split) when the blocks already fill two
    waves; otherwise the split count S, with at least ``min_tiles`` tiles
    each, that minimises waves x tiles per split (the time of the longest
    SM) plus ``split_cost`` tiles per split (the combine), the smaller S
    on a tie. Splits = ceil(tiles / the returned value)."""
    tiles = -(-Lk // TILE)
    slots = per_sm * sms
    if blocks >= 2 * slots:
        return tiles
    best, best_cost = tiles, None
    for S in range(1, max(1, tiles // min_tiles) + 1):
        tps = -(-tiles // S)
        splits = -(-tiles // tps)
        cost = -(-blocks * splits // slots) * tps + split_cost * splits
        if best_cost is None or cost < best_cost:
            best, best_cost = tps, cost
    return best


def flash_splits(BH: int, Lq: int, Lk: int, D: int, Dv: int,
                 sms: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """((S, tiles per split) of the forward, the same of the dq pass) of
    kernel #7 at these shapes on a card of ``sms`` SMs (``split_tiles``)."""
    per_sm = 2 if D <= 128 and Dv <= 128 else 1
    qt, tiles = -(-Lq // TILE), -(-Lk // TILE)
    out = []
    for blocks in (qt * BH, qt * BH * max(1, D // 128)):
        tps = split_tiles(blocks, Lk, per_sm, sms)
        out.append((-(-tiles // tps), tps))
    return out[0], out[1]


class KprojPlan(NamedTuple):
    """Host-side tiling of kernel #3 at one shape: (S, key tiles per
    split) of the forward, warpgroups of 64 queries per dq block and (S,
    key tiles per split) of the dq pass; (blocks, 64-row tiles per block)
    of the dWk pass over the BH * Lk stored rows."""
    fwd: tuple[int, int]
    dq_warpgroups: int
    dq: tuple[int, int]
    dw: tuple[int, int]


def kproj_plan(BH: int, Lq: int, Lk: int, grid_wh, sms: int) -> KprojPlan:
    """Kernel #3's tiling for a slot grid (w, h) on a card of ``sms`` SMs.
    The forward and the dq pass run ``KPROJ_WARPGROUPS`` per block, the dq
    pass one only where two do not fit its shared memory (w + h >
    KPROJ_DQ_MAX_ROPE_ROWS, slots above 34 x 34). Every pass holds one
    block per SM (~170-225 KB of shared memory), so the key splits follow
    ``split_tiles`` with one block per SM over ceil(Lq / (64 warpgroups)) x
    BH blocks, at least KPROJ_MIN_SPLIT_TILES tiles each (#3 has 2-4x
    fewer blocks than #7 at the path's shapes, and its splits pay off down
    to ~3 tiles), each split charged KPROJ_SPLIT_COST tiles for the
    combines (the dq combine grows by ~1/4 of a tile's time per split on
    the H100). The dWk pass spreads its ceil(BH Lk / 64) row tiles over
    at most one block per SM."""
    wg_dq = KPROJ_WARPGROUPS if sum(grid_wh) <= KPROJ_DQ_MAX_ROPE_ROWS else 1
    tiles = -(-Lk // TILE)
    splits = []
    for w in (KPROJ_WARPGROUPS, wg_dq):
        tps = split_tiles(-(-Lq // (TILE * w)) * BH, Lk, 1, sms,
                          KPROJ_MIN_SPLIT_TILES, KPROJ_SPLIT_COST)
        splits.append((-(-tiles // tps), tps))
    rows = -(-BH * Lk // TILE)
    per = -(-rows // min(rows, sms))
    return KprojPlan(splits[0], wg_dq, splits[1], (-(-rows // per), per))


@functools.lru_cache(maxsize=None)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class _FlashFn(torch.autograd.Function):
    """q [BH, Lq, D], k [BH, Lk, D], v [BH, Lk, Dv] (all bf16); bias [1 or
    BH, Lk] f32 or None."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        BH, Lq, D = q.shape
        Lk, Dv = v.shape[1:]
        dev = q.device
        (S, tps), _ = flash_splits(BH, Lq, Lk, D, Dv, _sms(dev))
        out = torch.empty((BH, Lq, Dv), dtype=q.dtype, device=dev)
        lse = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
        part = (torch.empty(S * BH * Lq * (Dv + 2), dtype=torch.float32,
                            device=dev) if S > 1 else None)
        lib = _flash_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.fa_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                _bias_stride(bias), out.data_ptr(), lse.data_ptr(),
                _ptr(part), BH, Lq, Lk, D, Dv, tps, stream)
        kernel_build.check_launch(status, "fa_fwd")
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        BH, Lq, D = q.shape
        Lk, Dv = v.shape[1:]
        dev = q.device
        _, (S, tps) = flash_splits(BH, Lq, Lk, D, Dv, _sms(dev))
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
        part = (torch.empty(S * BH * Lq * D, dtype=torch.float32, device=dev)
                if S > 1 else None)
        lib = _flash_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.fa_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                _bias_stride(bias), out.data_ptr(), lse.data_ptr(),
                dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                delta.data_ptr(), _ptr(part), BH, Lq, Lk, D, Dv, tps, stream)
        kernel_build.check_launch(status, "fa_bwd")
        flash_attention.backward_launches += 1
        return dq, dk, dv, None


def flash_attention(q, k, v, key_bias=None):
    """softmax(q k^T / sqrt(D) + key_bias) v.

    q [..., Lq, D]; k [..., Lk, D]; v [..., Lk, Dv]; key_bias [Lk] or
    [..., Lk] additive float32 (broadcast over the leading axes, heads
    included), or None. Returns [..., Lq, Dv] in q's dtype. On the card D
    and Dv must be in ``FLASH_WIDTHS``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bfloat16 {name}, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}")
    *lead, Lq, D = q.shape
    Lk, Dv = v.shape[-2:]
    if D not in FLASH_WIDTHS or Dv not in FLASH_WIDTHS:
        raise NotImplementedError(
            f"flash_attention kernel takes head widths D and value widths Dv "
            f"in {FLASH_WIDTHS}, got D {D}, Dv {Dv}")
    if (tuple(k.shape) != (*lead, Lk, D) or tuple(v.shape[:-2]) != tuple(lead)
            or Lq == 0 or Lk == 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    BH = math.prod(lead)
    bias = None
    if key_bias is not None:
        kb = key_bias.to(q.device, torch.float32)
        bias = (kb.reshape(1, Lk) if kb.ndim == 1 else
                kb.expand(*lead, Lk).reshape(BH, Lk)).contiguous()
    out = _FlashFn.apply(q.reshape(BH, Lq, D).contiguous(),
                         k.reshape(BH, Lk, D).contiguous(),
                         v.reshape(BH, Lk, Dv).contiguous(), bias)
    return out.reshape(*lead, Lq, Dv)


flash_attention.launches = 0
flash_attention.backward_launches = 0


def _flash_lib() -> ctypes.CDLL:
    lib = kernel_build.load("flash_attention")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.fa_fwd.argtypes = [P] * 4 + [L] + [P] * 3 + [I] * 6 + [P]
        lib.fa_fwd.restype = I
        lib.fa_bwd.argtypes = [P] * 4 + [L] + [P] * 8 + [I] * 6 + [P]
        lib.fa_bwd.restype = I
        lib._sam2_typed = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("flash_kproj")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.kproj_fwd.argtypes = [P] * 6 + [L] + [P] * 4 + [I] * 8 + [P]
        lib.kproj_fwd.restype = I
        lib.kproj_bwd.argtypes = [P] * 6 + [L] + [P] * 12 + [I] * 10 + [P]
        lib.kproj_bwd.restype = I
        lib._sam2_typed = True
    return lib
