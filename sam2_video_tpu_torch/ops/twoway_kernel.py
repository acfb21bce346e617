"""The mask decoder's two-way transformer block as a hand-written CUDA
kernel for Hopper, forward and backward.

Replaces the TPU kernel ``sam2_video_tpu/ops/twoway_kernel.py``
``fused_twoway_block`` (Pallas ``_twoway_fwd_kernel`` and the two backward
programs ``_twoway_bwd1_kernel`` / ``_twoway_bwd2_kernel``). Source:
``csrc/twoway_block.cu`` (the tile staging and wgmma wrappers of
``csrc/sm90_gemm.cuh`` / ``csrc/sm90.cuh``).

- One block over all objects: self-attention, token -> image attention,
  ReLU MLP, image -> token attention and four LayerNorms, with the token
  embedding (``qpe``) re-added as the queries' pe at every stage and the
  image pe (``kpe``, shared by the objects) on the image side.
- On H100 at SAM2-tiny 384 px (8 objects, 8 tokens, 576 image keys) the
  block is ~1.3 GFLOP of products on ~6 MB, a few microseconds of bound:
  what costs is latency, a chain of ~15 dependent steps, most over only
  the O N token rows. Each direction is one cooperative launch (and the
  memset of its grid barrier) that walks the chain as stages between
  grid-wide barriers, every product as 64 x 64 wgmma tiles spread over the
  SMs (a token product's weights stream through as many SMs as it has
  column tiles), the attentions as jobs per (object, head[, key split]) or
  per 16 / 32 image rows. Objects attend only to their own keys, so the
  TPU's block-diagonal object mask and its VMEM group sizing have no
  counterpart. The softmax sums run in torch's order, so that the MLP's
  ReLU mask mostly agrees with the plain block's; where a bit still flips
  (a pre-activation a rounding away from 0), the gradients follow the
  kernel's mask, and a comparison takes the plain backward through it
  (``relu_hidden``, ``PlainReluMask``).
- The forward keeps its activations in one workspace tensor that autograd
  holds until the backward, in place of the TPU's recompute programs B1 and
  B2. Weight gradients are float32, summed in a fixed order (no float
  atomics: the same bits from run to run); the backward skips them where
  autograd needs none (a frozen decoder in the memory-only train step).
- The kernel is specialised to the SAM2 decoder's geometry: d_model 256, 8
  heads, self-attention head dim 32, cross-attention head dim 16 (downsample
  2), MLP 2048, bf16. Any object count, token count and HW. A CUDA tensor of
  another geometry raises ``NotImplementedError``; the JAX package takes
  its XLA block there (``fused_twoway_eligible``), the port does not fall
  back.

Operands (``pack``, the counterpart of ``_block_operands``): the TPU kernel
stacks each projection per head ([H, hd, C] for q, k, v, [H, C, hd] for the
out-projection) so that it never slices lanes; here a head is a column
range of the [internal, C] weight as it is, and the out-projection stays
[C, internal], one GEMM whose f32 accumulator sums the heads before its one
rounding, as the TPU's per-head accumulator does. ``models/sam2.py``
``derive`` keeps the pack on each decoder block as its ``_ops`` entry.

``fused_twoway_block`` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors (or raises). ``.launches`` counts forward
launches, ``.backward_launches`` backward ones.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ..models import mask_decoder as md
from . import kernel_build

D_MODEL, HEADS, SELF_DIM, CROSS_DIM, MLP_DIM = 256, 8, 256, 128, 2048
_T2I, _I2T = "cross_attn_token_to_image", "cross_attn_image_to_token"


# the block's leaves in the order of the kernel's f32 gradient buffer
# (csrc/twoway_block.cu G_* then I_*)
LEAVES = (
    ("self_attn", "q_proj", "weight"), ("self_attn", "k_proj", "weight"),
    ("self_attn", "v_proj", "weight"), ("self_attn", "q_proj", "bias"),
    ("self_attn", "k_proj", "bias"), ("self_attn", "v_proj", "bias"),
    ("self_attn", "out_proj", "weight"), ("self_attn", "out_proj", "bias"),
    ("norm1", "weight"), ("norm1", "bias"),
    (_T2I, "q_proj", "weight"), (_T2I, "q_proj", "bias"),
    (_T2I, "out_proj", "weight"), (_T2I, "out_proj", "bias"),
    ("norm2", "weight"), ("norm2", "bias"),
    ("mlp", "layers", "0", "weight"), ("mlp", "layers", "0", "bias"),
    ("mlp", "layers", "1", "weight"), ("mlp", "layers", "1", "bias"),
    ("norm3", "weight"), ("norm3", "bias"),
    (_I2T, "k_proj", "weight"), (_I2T, "k_proj", "bias"),
    (_I2T, "v_proj", "weight"), (_I2T, "v_proj", "bias"),
    (_T2I, "k_proj", "weight"), (_I2T, "q_proj", "weight"),
    (_T2I, "k_proj", "bias"), (_I2T, "q_proj", "bias"),
    (_T2I, "v_proj", "weight"), (_T2I, "v_proj", "bias"),
    (_I2T, "out_proj", "weight"), (_I2T, "out_proj", "bias"),
    ("norm4", "weight"), ("norm4", "bias"))


def _leaf(p, path):
    for k in path:
        p = p[k]
    return p


def leaves(p):
    """The block's 36 parameter tensors in ``LEAVES`` order."""
    return [_leaf(p, path) for path in LEAVES]


def block_params(w):
    """The block's parameter tree from tensors in ``LEAVES`` order."""
    p: dict = {}
    for path, t in zip(LEAVES, w, strict=True):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return p


def twoway_block_plain(p, queries, keys, qpe, kpe, first: bool,
                       heads: int = HEADS):
    """The plain PyTorch block, per object (``models/mask_decoder.py``
    ``_twoway_block``, whose products, softmax and adds round where the
    TPU kernel's ``_MHA.fwd`` and ``_twoway_fwd_kernel`` do). queries, qpe
    [O, N, C]; keys [O, HW, C]; kpe [HW, C]. Returns (queries', keys')."""
    return md._twoway_block(p, queries, keys, qpe, kpe[None], heads,
                            skip_first_pe=bool(first))


class PlainReluMask(TorchFunctionMode):
    """Within it, ``torch.nn.functional.relu`` (the plain block's MLP
    activation, its only ReLU) passes its input where ``mask`` is set and 0
    elsewhere, in value and in gradient, and keeps that input (the
    pre-activation) as ``.pre``: the plain block taken through another
    forward's ReLU mask, the kernel's from ``relu_hidden``. With ``mask``
    None the ReLU is torch's and ``.pre`` is only recorded."""

    def __init__(self, mask: torch.Tensor | None):
        super().__init__()
        self.mask, self.pre = mask, None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.relu:
            return func(*args, **kwargs)
        h = args[0]
        self.pre = h.detach()
        if self.mask is None:
            return func(*args, **kwargs)
        return torch.where(self.mask, h, torch.zeros_like(h))


def relu_hidden(out: torch.Tensor) -> torch.Tensor:
    """The MLP hidden activation relu(x2 W1^T + b1), bf16 [O, N, 2048], of
    the kernel's forward that returned ``out`` (either output of a
    ``fused_twoway_block`` call on the card, its graph not yet freed by a
    backward): a view of the saved activations; its ReLU mask (> 0) is the
    one the kernel's backward reads."""
    x, k0, _, _, _, fws = out.grad_fn.saved_tensors[:6]
    O, N, _ = x.shape
    off = _lib().twoway_hidden_offset(O, N, k0.shape[1])
    return fws[off:off + O * N * MLP_DIM * 2].view(torch.bfloat16).view(
        O, N, MLP_DIM)


def pack(p):
    """Kernel operands of one block (``csrc/twoway_block.cu`` W_*): bf16
    product weights in [out, in] layout, float32 biases and LayerNorm
    parameters; the self-attention's q, k, v stacked, and the token ->
    image k-projection stacked over the image -> token q-projection (both
    read the image keys plus pe)."""
    def bf(*ts):
        return torch.cat([t.to(torch.bfloat16) for t in ts]).contiguous()

    def f32(*ts):
        return torch.cat([t.float() for t in ts]).contiguous()

    s, t, i = p["self_attn"], p[_T2I], p[_I2T]
    mlp = p["mlp"]["layers"]

    def w(a, *names):
        return bf(*(a[n]["weight"] for n in names))

    def b(a, *names):
        return f32(*(a[n]["bias"] for n in names))

    def ln(n):
        return [f32(p[n]["weight"]), f32(p[n]["bias"])]

    return ([w(s, "q_proj", "k_proj", "v_proj"),
             b(s, "q_proj", "k_proj", "v_proj"), w(s, "out_proj"),
             b(s, "out_proj")] + ln("norm1")
            + [w(t, "q_proj"), b(t, "q_proj"),
               bf(t["k_proj"]["weight"], i["q_proj"]["weight"]),
               f32(t["k_proj"]["bias"], i["q_proj"]["bias"]),
               w(t, "v_proj"), b(t, "v_proj"), w(t, "out_proj"),
               b(t, "out_proj")] + ln("norm2")
            + [w(mlp, "0"), b(mlp, "0"), w(mlp, "1"), b(mlp, "1")]
            + ln("norm3")
            + [w(i, "k_proj"), b(i, "k_proj"), w(i, "v_proj"),
               b(i, "v_proj"), w(i, "out_proj"), b(i, "out_proj")]
            + ln("norm4"))


def check_geometry(p, queries, keys, qpe, kpe, heads: int) -> None:
    """Raise unless the kernel takes these CUDA tensors: bf16 everywhere
    (TypeError) and the SAM2 decoder's geometry (NotImplementedError)."""
    for name, t in (("queries", queries), ("keys", keys), ("qpe", qpe),
                    ("kpe", kpe)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_twoway_block kernel takes bfloat16 "
                            f"{name}, got {t.dtype}")
    O, N, C = queries.shape if queries.dim() == 3 else (0, 0, 0)
    HW = keys.shape[1] if keys.dim() == 3 else 0
    dims = (p["self_attn"]["q_proj"]["weight"].shape[0],
            p[_T2I]["q_proj"]["weight"].shape[0],
            p[_I2T]["q_proj"]["weight"].shape[0],
            p["mlp"]["layers"]["0"]["weight"].shape[0])
    if (O > 0 and N > 0 and HW > 0 and C == D_MODEL and heads == HEADS
            and tuple(keys.shape) == (O, HW, C)
            and tuple(qpe.shape) == (O, N, C)
            and tuple(kpe.shape) == (HW, C)
            and dims == (SELF_DIM, CROSS_DIM, CROSS_DIM, MLP_DIM)):
        return
    raise NotImplementedError(
        "fused_twoway_block kernel takes the SAM2 decoder geometry (d_model "
        f"{D_MODEL}, {HEADS} heads, self / cross internal {SELF_DIM} / "
        f"{CROSS_DIM}, MLP {MLP_DIM}; queries and qpe [O, N, C], keys "
        f"[O, HW, C], kpe [HW, C]), got {heads} heads, self / t2i / i2t "
        f"internal and MLP {dims}, queries {tuple(queries.shape)}, keys "
        f"{tuple(keys.shape)}, qpe {tuple(qpe.shape)}, kpe "
        f"{tuple(kpe.shape)}")


def _table(ops):
    return (ctypes.c_void_p * len(ops))(*(t.data_ptr() for t in ops))


class _TwowayFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k0, qpe, kpe, first, ops, *w):
        O, N, _ = x.shape
        HW = k0.shape[1]
        dev = x.device
        lib = _lib()
        fws = torch.empty(lib.twoway_workspace_bytes(O, N, HW, 0),
                          dtype=torch.uint8, device=dev)
        xout, kout = torch.empty_like(x), torch.empty_like(k0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.twoway_fwd(
                x.data_ptr(), k0.data_ptr(), qpe.data_ptr(), kpe.data_ptr(),
                _table(ops), xout.data_ptr(), kout.data_ptr(), fws.data_ptr(),
                O, N, HW, int(first), stream)
        kernel_build.check_launch(status, "twoway_fwd")
        fused_twoway_block.launches += 1
        ctx.first, ctx.ops = first, ops
        ctx.save_for_backward(x, k0, qpe, kpe, xout, fws, *w)
        return xout, kout

    @staticmethod
    def backward(ctx, dxo, dko):
        x, k0, qpe, kpe, xout, fws, *w = ctx.saved_tensors
        need_w = ctx.needs_input_grad[6:]
        wgrad = any(need_w)
        O, N, _ = x.shape
        HW = k0.shape[1]
        dev = x.device
        lib = _lib()
        dxo = dxo.to(x.dtype).contiguous()
        dko = dko.to(k0.dtype).contiguous()
        dx, dk0 = torch.empty_like(x), torch.empty_like(k0)
        dqpe, dkpe = torch.empty_like(qpe), torch.empty_like(kpe)
        grads = torch.empty(lib.twoway_grad_floats() if wgrad else 1,
                            dtype=torch.float32, device=dev)
        ws = torch.empty(lib.twoway_workspace_bytes(O, N, HW, 1),
                         dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.twoway_bwd(
                x.data_ptr(), k0.data_ptr(), qpe.data_ptr(), kpe.data_ptr(),
                _table(ctx.ops), xout.data_ptr(), fws.data_ptr(),
                dxo.data_ptr(), dko.data_ptr(), dx.data_ptr(),
                dk0.data_ptr(), dqpe.data_ptr(), dkpe.data_ptr(),
                grads.data_ptr(), ws.data_ptr(), O, N, HW, int(ctx.first),
                int(wgrad), stream)
        kernel_build.check_launch(status, "twoway_bwd")
        fused_twoway_block.backward_launches += 1
        if wgrad:
            parts = torch.split(grads, [t.numel() for t in w])
            wg = tuple(g.view(t.shape).to(t.dtype) if need else None
                       for g, t, need in zip(parts, w, need_w))
        else:
            wg = (None,) * len(w)
        return (dx, dk0, dqpe, dkpe, None, None) + wg


def fused_twoway_block(p, queries, keys, qpe, kpe, first: bool,
                       heads: int = HEADS):
    """Differentiable two-way block (the JAX function's contract without
    its batch axis): p a ``_twoway_block_init`` tree; queries [O, N, C],
    keys [O, HW, C], qpe [O, N, C] (the original token embedding), kpe
    [HW, C] (the image pe, shared by the objects). Returns (queries' [O, N,
    C], keys' [O, HW, C]); the backward gives every weight, queries, keys,
    qpe and kpe a gradient."""
    if queries.device.type == "cpu":
        return twoway_block_plain(p, queries, keys, qpe, kpe, first, heads)
    if not queries.is_cuda:
        raise ValueError(f"fused_twoway_block: unsupported device "
                         f"{queries.device}")
    check_geometry(p, queries, keys, qpe, kpe, heads)
    ops = p.get("_ops")
    if ops is None:
        with torch.no_grad():
            ops = pack(p)
    return _TwowayFn.apply(queries.contiguous(), keys.contiguous(),
                           qpe.contiguous(), kpe.contiguous(), bool(first),
                           tuple(ops), *leaves(p))


fused_twoway_block.launches = 0
fused_twoway_block.backward_launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("twoway_block")
    if not getattr(lib, "_sam2_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        T = ctypes.POINTER(ctypes.c_void_p)
        lib.twoway_grad_floats.argtypes = []
        lib.twoway_grad_floats.restype = L
        lib.twoway_workspace_bytes.argtypes = [I] * 4
        lib.twoway_workspace_bytes.restype = L
        lib.twoway_hidden_offset.argtypes = [I] * 3
        lib.twoway_hidden_offset.restype = L
        lib.twoway_fwd.argtypes = [P] * 4 + [T] + [P] * 3 + [I] * 4 + [P]
        lib.twoway_fwd.restype = I
        lib.twoway_bwd.argtypes = ([P] * 4 + [T] + [P] * 10 + [I] * 5
                                   + [P])
        lib.twoway_bwd.restype = I
        lib._sam2_typed = True
    return lib
