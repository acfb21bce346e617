"""Memory attention (counterpart of
``sam2_video_tpu/models/memory_attention.py``).

The memory sequence is a fixed-shape concatenation of spatial-memory slots
and object-pointer tokens; invalid keys are removed by an additive float32
bias. RoPE runs in the de-interleaved layout: the permutation is applied to
the q/k projection rows by ``prepare``, under the derived entries
``_qp``/``_kp`` (as in the JAX package; under autograd when the weights
train). With one head the cross-attention commutes the value projection:
softmax rows sum to 1, so P (m Wv + bv) = (P m) Wv + bv, and PV runs on the
raw 64-dim memory.

``use_flash=True`` takes the fused layer path where the kernels cover the
configuration (``fused_eligible``: one head, ReLU, the default pos-enc
flags, d_model 256, kv_in_dim 64): per layer ``fused_self_block`` ->
``flash_attention_kproj`` -> ``fused_tail_block``, the kernels on a CUDA
tensor and their plain versions on a CPU tensor. The block kernels take a
grid of h*w % 32 == 0 tokens; another grid raises on a CUDA tensor
(ROADMAP.md, queue 2, item 9). Otherwise the layers run plain, and the
cross-attention takes the flash-kproj kernel where only that kernel
applies, else the generic ``flash_attention`` (as the JAX package routes
them): several heads with a projected v, or one head with the raw memory
as v. Its self-attention stays plain ``sdpa``, where the JAX package runs
XLA. ``use_flash=False`` runs every attention through plain ``sdpa``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import common as nn
from ..ops import memattn_layer_kernel as mlk
from ..ops.attention import merge_heads, sdpa, split_heads
from ..ops.flash_attention import (KERNEL_DIM, KERNEL_KV, flash_attention,
                                   flash_attention_kproj)
from ..ops.position_encoding import (apply_rope_half, axial_rope_table_half,
                                     deinterleave_perm)


@dataclasses.dataclass(frozen=True)
class MemoryAttentionConfig:
    d_model: int = 256
    num_layers: int = 4
    dim_feedforward: int = 2048
    num_heads: int = 1
    kv_in_dim: int = 64
    rope_theta: float = 10000.0
    pos_enc_at_input: bool = True
    pos_enc_at_attn: bool = False
    pos_enc_at_cross_attn_keys: bool = True
    pos_enc_at_cross_attn_queries: bool = False
    activation: str = "relu"
    use_flash: bool = True


RAGGED_GRID_NOT_PORTED = (
    "the fused memory-attention block kernels take a grid of h*w % 32 == 0 "
    "tokens; other grids are not ported to CUDA yet: see ROADMAP.md, queue "
    "2, item 9")


def kproj_eligible(cfg: MemoryAttentionConfig) -> bool:
    """The cross-attention fits ``flash_attention_kproj``: one head (the
    v-commute), d_model 256 and kv_in_dim 64 (the kernel's widths)."""
    return (cfg.num_heads == 1 and cfg.d_model == KERNEL_DIM
            and cfg.kv_in_dim == KERNEL_KV)


def fused_eligible(cfg: MemoryAttentionConfig) -> bool:
    """The whole layer fits the three kernels: the cross-attention's
    conditions, a ReLU feed-forward and the default pos-enc flags (no
    positional encoding added inside the blocks)."""
    return (cfg.use_flash and kproj_eligible(cfg) and cfg.activation == "relu"
            and not cfg.pos_enc_at_attn
            and not cfg.pos_enc_at_cross_attn_queries)


def _rope_attn_init(gen, embed_dim, num_heads, kv_in_dim=None):
    kv = kv_in_dim if kv_in_dim is not None else embed_dim
    return {
        "q_proj": nn.linear_init(gen, embed_dim, embed_dim),
        "k_proj": nn.linear_init(gen, kv, embed_dim),
        "v_proj": nn.linear_init(gen, kv, embed_dim),
        "out_proj": nn.linear_init(gen, embed_dim, embed_dim),
    }


def _layer_init(gen, cfg: MemoryAttentionConfig):
    return {
        "self_attn": _rope_attn_init(gen, cfg.d_model, cfg.num_heads),
        "cross_attn_image": _rope_attn_init(gen, cfg.d_model, cfg.num_heads,
                                            cfg.kv_in_dim),
        "linear1": nn.linear_init(gen, cfg.d_model, cfg.dim_feedforward),
        "linear2": nn.linear_init(gen, cfg.dim_feedforward, cfg.d_model),
        "norm1": nn.layer_norm_init(cfg.d_model),
        "norm2": nn.layer_norm_init(cfg.d_model),
        "norm3": nn.layer_norm_init(cfg.d_model),
    }


def init(gen: torch.Generator, cfg: MemoryAttentionConfig):
    return {"layers": {str(i): _layer_init(gen, cfg)
                       for i in range(cfg.num_layers)},
            "norm": nn.layer_norm_init(cfg.d_model)}


def _perm_rows(p, perm):
    out = {"weight": p["weight"][perm]}
    if "bias" in p:
        out["bias"] = p["bias"][perm]
    return out


def _perm(ap, num_heads: int):
    rows = ap["q_proj"]["weight"].shape[0]
    return torch.as_tensor(deinterleave_perm(rows, num_heads),
                           device=ap["q_proj"]["weight"].device)


def prepare(p, cfg: MemoryAttentionConfig) -> dict:
    """``p`` as a nested dict with the de-interleave permutation applied to
    every q/k projection's output rows, under ``_qp``/``_kp`` (the JAX
    ``prepare``). Differentiable: the train step calls it in every step."""
    tree = p.tree() if isinstance(p, nn.ParamTree) else _copy_tree(p)
    for lp in tree["layers"].values():
        for ap in (lp["self_attn"], lp["cross_attn_image"]):
            perm = _perm(ap, cfg.num_heads)
            ap["_qp"] = _perm_rows(ap["q_proj"], perm)
            ap["_kp"] = _perm_rows(ap["k_proj"], perm)
    return tree


def _copy_tree(p: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in p.items()}


def _permed(ap, key: str, num_heads: int):
    """Projection ``key`` ('q_proj'/'k_proj') with the de-interleave
    permutation on its output rows: the ``prepare`` entry, else made here."""
    made = ap.get("_qp" if key == "q_proj" else "_kp")
    return made if made is not None else _perm_rows(ap[key],
                                                    _perm(ap, num_heads))


def _self_attn(p, cfg, tgt, query_pos, rope_q):
    tgt2 = nn.layer_norm(p["norm1"], tgt)
    ap = p["self_attn"]
    qk_in = tgt2 + query_pos if cfg.pos_enc_at_attn else tgt2
    q = nn.linear(_permed(ap, "q_proj", cfg.num_heads), qk_in)
    k = nn.linear(_permed(ap, "k_proj", cfg.num_heads), qk_in)
    v = nn.linear(ap["v_proj"], tgt2)
    if cfg.num_heads > 1:
        q, k, v = (split_heads(x, cfg.num_heads) for x in (q, k, v))
    q = apply_rope_half(q, *rope_q)
    k = apply_rope_half(k, *rope_q)
    out = sdpa(q, k, v)
    if cfg.num_heads > 1:
        out = merge_heads(out)
    return tgt + nn.linear(ap["out_proj"], out)


def _cross_attn(p, cfg, tgt, memory, query_pos, pos, rope_q, rope_k,
                num_spatial_k: int, key_valid, feat_hw):
    """q gets RoPE; the leading ``num_spatial_k`` keys get the tiled RoPE,
    the trailing object-pointer keys none; invalid keys get a -1e9 bias."""
    tgt2 = nn.layer_norm(p["norm2"], tgt)
    q_in = tgt2 + query_pos if cfg.pos_enc_at_cross_attn_queries else tgt2
    k_in = memory + pos if cfg.pos_enc_at_cross_attn_keys else memory
    ap = p["cross_attn_image"]
    q = nn.linear(_permed(ap, "q_proj", cfg.num_heads), q_in)
    key_bias = (torch.where(key_valid, 0.0, -1e9).float()
                if key_valid is not None else None)
    if cfg.use_flash and kproj_eligible(cfg):
        # the k-projection and RoPE fused into the attention kernel
        kp = _permed(ap, "k_proj", cfg.num_heads)
        h, w = feat_hw
        attn = flash_attention_kproj(
            apply_rope_half(q, *rope_q), k_in, memory, kp["weight"],
            kp["bias"], key_bias, num_spatial_k, (w, h), cfg.rope_theta)
        return tgt + nn.linear(ap["out_proj"], nn.linear(ap["v_proj"], attn))
    k = nn.linear(_permed(ap, "k_proj", cfg.num_heads), k_in)
    if cfg.num_heads > 1:
        q = split_heads(q, cfg.num_heads)
        k = split_heads(k, cfg.num_heads)
    commute_v = cfg.num_heads == 1
    if commute_v:
        v = memory
    else:
        v = split_heads(nn.linear(ap["v_proj"], memory), cfg.num_heads)
    q = apply_rope_half(q, *rope_q)
    k_spatial = apply_rope_half(k[..., :num_spatial_k, :], *rope_k)
    k = torch.cat([k_spatial, k[..., num_spatial_k:, :]], dim=-2)
    if cfg.use_flash:
        # the generic flash attention, kernel #7; the [Lk] key bias
        # broadcasts over objects and heads
        attn = flash_attention(q, k, v, key_bias)
    else:
        bias = (key_bias.reshape((1,) * (q.ndim - 1) + key_bias.shape)
                if key_bias is not None else None)
        attn = sdpa(q, k, v, bias)
    if cfg.num_heads > 1:
        attn = merge_heads(attn)
    if commute_v:
        attn = nn.linear(ap["v_proj"], attn)
    return tgt + nn.linear(ap["out_proj"], attn)


def apply(p, cfg: MemoryAttentionConfig, curr, memory, curr_pos, memory_pos,
          feat_hw: tuple[int, int], num_spatial_k: int,
          key_valid: torch.Tensor | None = None):
    """curr [B, Lq, d_model]; memory [B, Lk, kv_in_dim] (spatial slots then
    pointers); curr_pos [B or 1, Lq, d_model]; memory_pos
    [B or 1, Lk, kv_in_dim]; key_valid [Lk] bool."""
    h, w = feat_hw
    if h * w != curr.shape[-2]:
        raise ValueError(f"feat_hw {feat_hw} does not match {curr.shape}")
    head_dim = cfg.d_model // cfg.num_heads
    rope_q = axial_rope_table_half(head_dim, w, h, cfg.rope_theta,
                                   device=curr.device)
    reps = num_spatial_k // (h * w)
    if reps * h * w != num_spatial_k:
        raise ValueError("num_spatial_k must be a multiple of h*w")
    rope_k = (rope_q[0].repeat(reps, 1), rope_q[1].repeat(reps, 1))

    output = curr
    if cfg.pos_enc_at_input and curr_pos is not None:
        output = output + 0.1 * curr_pos
    if fused_eligible(cfg):
        if curr.is_cuda and h * w % 32:
            raise NotImplementedError(RAGGED_GRID_NOT_PORTED)
        return _fused_layers(p, cfg, output, memory, memory_pos, rope_q,
                             num_spatial_k, key_valid, (w, h))

    act = {"relu": F.relu, "gelu": nn.gelu}[cfg.activation]
    for i in range(cfg.num_layers):
        lp = p["layers"][str(i)]
        output = _self_attn(lp, cfg, output, curr_pos, rope_q)
        output = _cross_attn(lp, cfg, output, memory, curr_pos, memory_pos,
                             rope_q, rope_k, num_spatial_k, key_valid,
                             feat_hw)
        tgt2 = nn.layer_norm(lp["norm3"], output)
        tgt2 = nn.linear(lp["linear2"], act(nn.linear(lp["linear1"], tgt2)))
        output = output + tgt2
    return nn.layer_norm(p["norm"], output)


def _fused_layers(p, cfg, output, memory, memory_pos, rope_q, num_spatial_k,
                  key_valid, grid_wh):
    """Each layer as self block -> flash cross-attention (k-projection and
    RoPE fused, v-commuted) -> tail block (``ops/memattn_layer_kernel.py``,
    ``ops/flash_attention.py``), then the final LayerNorm."""
    k_in = (memory + memory_pos if cfg.pos_enc_at_cross_attn_keys
            else memory)
    key_bias = (torch.where(key_valid, 0.0, -1e9).float()
                if key_valid is not None else None)
    cos32, sin32 = (t.float() for t in rope_q)
    for i in range(cfg.num_layers):
        lp = p["layers"][str(i)]
        sp, cp = lp["self_attn"], lp["cross_attn_image"]
        p_self = {"q": _permed(sp, "q_proj", 1), "k": _permed(sp, "k_proj", 1),
                  "v": sp["v_proj"], "out": sp["out_proj"]}
        output, q3 = mlk.fused_self_block(
            p_self, _permed(cp, "q_proj", 1), lp["norm1"], lp["norm2"],
            output, cos32, sin32)
        kp = _permed(cp, "k_proj", 1)
        attn = flash_attention_kproj(q3, k_in, memory, kp["weight"],
                                     kp["bias"], key_bias, num_spatial_k,
                                     grid_wh, cfg.rope_theta)
        output = mlk.fused_tail_block(
            cp["v_proj"], cp["out_proj"], lp["norm3"], lp["linear1"],
            lp["linear2"], output, attn)
    return nn.layer_norm(p["norm"], output)
