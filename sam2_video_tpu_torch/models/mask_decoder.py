"""Two-way-transformer mask decoder, the SAM head (counterpart of
``sam2_video_tpu/models/mask_decoder.py``). Output-token order is
[obj_score | iou | 4 mask tokens]. With ``fused_twoway`` (off by default,
as in the JAX package) the two-way blocks run kernel #8,
``ops/twoway_kernel.py`` ``fused_twoway_block``."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import common as nn
from ..ops.attention import merge_heads, sdpa, split_heads


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    transformer_num_heads: int = 8
    attention_downsample_rate: int = 2
    # route the two-way blocks through kernel #8 (the JAX switch)
    fused_twoway: bool = False
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    use_high_res_features: bool = True
    iou_prediction_use_sigmoid: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    use_multimask_token_for_obj_ptr: bool = False
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def _attn_init(gen, embed_dim, num_heads, downsample_rate=1, kv_in_dim=None):
    kv_in_dim = kv_in_dim if kv_in_dim is not None else embed_dim
    internal = embed_dim // downsample_rate
    return {
        "q_proj": nn.linear_init(gen, embed_dim, internal),
        "k_proj": nn.linear_init(gen, kv_in_dim, internal),
        "v_proj": nn.linear_init(gen, kv_in_dim, internal),
        "out_proj": nn.linear_init(gen, internal, embed_dim),
    }


def _attn(p, q, k, v, num_heads: int):
    q = split_heads(nn.linear(p["q_proj"], q), num_heads)
    k = split_heads(nn.linear(p["k_proj"], k), num_heads)
    v = split_heads(nn.linear(p["v_proj"], v), num_heads)
    return nn.linear(p["out_proj"], merge_heads(sdpa(q, k, v)))


def _twoway_block_init(gen, cfg: MaskDecoderConfig):
    d, h, r = (cfg.transformer_dim, cfg.transformer_num_heads,
               cfg.attention_downsample_rate)
    return {
        "self_attn": _attn_init(gen, d, h),
        "norm1": nn.layer_norm_init(d),
        "cross_attn_token_to_image": _attn_init(gen, d, h, r),
        "norm2": nn.layer_norm_init(d),
        "mlp": nn.mlp_init(gen, d, cfg.transformer_mlp_dim, d, 2),
        "norm3": nn.layer_norm_init(d),
        "norm4": nn.layer_norm_init(d),
        "cross_attn_image_to_token": _attn_init(gen, d, h, r),
    }


def _twoway_block(p, queries, keys, query_pe, key_pe, num_heads,
                  skip_first_pe):
    if skip_first_pe:
        queries = _attn(p["self_attn"], queries, queries, queries, num_heads)
    else:
        q = queries + query_pe
        queries = queries + _attn(p["self_attn"], q, q, queries, num_heads)
    queries = nn.layer_norm(p["norm1"], queries)

    q = queries + query_pe
    k = keys + key_pe
    queries = queries + _attn(p["cross_attn_token_to_image"], q, k, keys,
                              num_heads)
    queries = nn.layer_norm(p["norm2"], queries)

    queries = queries + nn.mlp(p["mlp"], queries, activation="relu")
    queries = nn.layer_norm(p["norm3"], queries)

    q = queries + query_pe
    k = keys + key_pe
    keys = keys + _attn(p["cross_attn_image_to_token"], k, q, queries,
                        num_heads)
    keys = nn.layer_norm(p["norm4"], keys)
    return queries, keys


def _transformer_init(gen, cfg: MaskDecoderConfig):
    return {
        "layers": {str(i): _twoway_block_init(gen, cfg)
                   for i in range(cfg.transformer_depth)},
        "final_attn_token_to_image": _attn_init(
            gen, cfg.transformer_dim, cfg.transformer_num_heads,
            cfg.attention_downsample_rate),
        "norm_final_attn": nn.layer_norm_init(cfg.transformer_dim),
    }


def _transformer(p, cfg, image_embedding, image_pe_2d, point_embedding):
    """image_embedding [B, HW, C]; image_pe_2d [HW, C], shared across the
    object batch; point_embedding [B, N, C]."""
    queries, keys = point_embedding, image_embedding
    image_pe = image_pe_2d[None]
    if cfg.fused_twoway:
        queries, keys = _transformer_blocks_fused(p, cfg, queries, keys,
                                                  image_pe_2d)
    else:
        for i in range(cfg.transformer_depth):
            queries, keys = _twoway_block(
                p["layers"][str(i)], queries, keys, point_embedding,
                image_pe, cfg.transformer_num_heads, skip_first_pe=(i == 0))
    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + _attn(p["final_attn_token_to_image"], q, k, keys,
                              cfg.transformer_num_heads)
    queries = nn.layer_norm(p["norm_final_attn"], queries)
    return queries, keys


def _transformer_blocks_fused(p, cfg, queries, keys, image_pe_2d):
    """The two-way blocks through kernel #8 (the JAX package's
    ``_transformer_blocks_fused``): the pe of the queries in both blocks
    is the original token embedding, the image pe is cast to the keys'
    dtype. On a CUDA tensor the kernel runs or raises; there is no
    fallback to the plain blocks."""
    from ..ops import twoway_kernel as twk

    qpe = queries
    kpe = image_pe_2d.to(keys.dtype)
    for i in range(cfg.transformer_depth):
        queries, keys = twk.fused_twoway_block(
            p["layers"][str(i)], queries, keys, qpe, kpe, first=(i == 0),
            heads=cfg.transformer_num_heads)
    return queries, keys


def init(gen: torch.Generator, cfg: MaskDecoderConfig):
    d = cfg.transformer_dim
    p = {
        "transformer": _transformer_init(gen, cfg),
        "iou_token": nn.embedding_init(gen, 1, d),
        "mask_tokens": nn.embedding_init(gen, cfg.num_mask_tokens, d),
        "output_upscaling": {
            "0": nn.conv_transpose2d_init(gen, d, d // 4, 2),
            "1": nn.layer_norm_init(d // 4),
            "3": nn.conv_transpose2d_init(gen, d // 4, d // 8, 2),
        },
        "output_hypernetworks_mlps": {
            str(i): nn.mlp_init(gen, d, d, d // 8, 3)
            for i in range(cfg.num_mask_tokens)},
        "iou_prediction_head": nn.mlp_init(
            gen, d, cfg.iou_head_hidden_dim, cfg.num_mask_tokens,
            cfg.iou_head_depth),
    }
    if cfg.pred_obj_scores:
        p["obj_score_token"] = nn.embedding_init(gen, 1, d)
        if cfg.pred_obj_scores_mlp:
            p["pred_obj_score_head"] = nn.mlp_init(gen, d, d, 1, 3)
        else:
            p["pred_obj_score_head"] = nn.linear_init(gen, d, 1)
    if cfg.use_high_res_features:
        p["conv_s0"] = nn.conv2d_init(gen, d, d // 8, 1)
        p["conv_s1"] = nn.conv2d_init(gen, d, d // 4, 1)
    return p


def predict_masks(p, cfg: MaskDecoderConfig, image_embeddings, image_pe,
                  sparse_prompt_embeddings, dense_prompt_embeddings,
                  high_res_features=None):
    """image_embeddings [B, H, W, C]; image_pe [H, W, C]; sparse [B, N, C];
    dense [B, H, W, C]; high_res_features already projected by
    conv_s0/conv_s1. Returns (masks [B, M, 4H, 4W], iou_pred [B, M],
    mask_tokens_out [B, M, C], object_score_logits [B, 1])."""
    B = sparse_prompt_embeddings.shape[0]
    s = 1 if cfg.pred_obj_scores else 0
    toks = [p["iou_token"]["weight"], p["mask_tokens"]["weight"]]
    if cfg.pred_obj_scores:
        toks.insert(0, p["obj_score_token"]["weight"])
    output_tokens = torch.cat(toks, dim=0)
    output_tokens = output_tokens[None].expand(B, *output_tokens.shape)
    tokens = torch.cat([output_tokens.to(sparse_prompt_embeddings.dtype),
                        sparse_prompt_embeddings], dim=1)

    _, H, W, C = image_embeddings.shape
    src = (image_embeddings + dense_prompt_embeddings).reshape(B, H * W, C)
    pe_2d = image_pe.reshape(H * W, C).to(src.dtype)

    hs, src = _transformer(p["transformer"], cfg, src, pe_2d, tokens)
    iou_token_out = hs[:, s]
    mask_tokens_out = hs[:, s + 1: s + 1 + cfg.num_mask_tokens]

    src = src.reshape(B, H, W, C)
    up = p["output_upscaling"]
    dc1 = nn.conv_transpose2d(up["0"], src, stride=2)
    if cfg.use_high_res_features:
        feat_s0, feat_s1 = high_res_features
        x = nn.gelu(nn.layer_norm_2d(up["1"], dc1 + feat_s1))
        upscaled = nn.gelu(nn.conv_transpose2d(up["3"], x, stride=2)
                           + feat_s0)
    else:
        x = nn.gelu(nn.layer_norm_2d(up["1"], dc1))
        upscaled = nn.gelu(nn.conv_transpose2d(up["3"], x, stride=2))

    hyper_in = torch.stack(
        [nn.mlp(p["output_hypernetworks_mlps"][str(i)], mask_tokens_out[:, i],
                activation="relu")
         for i in range(cfg.num_mask_tokens)], dim=1)     # [B, M, C/8]
    masks = torch.einsum("bmc,bhwc->bmhw", hyper_in.float(),
                         upscaled.float()).to(hyper_in.dtype)

    iou_pred = nn.mlp(p["iou_prediction_head"], iou_token_out,
                      activation="relu",
                      sigmoid_output=cfg.iou_prediction_use_sigmoid)
    if cfg.pred_obj_scores:
        if cfg.pred_obj_scores_mlp:
            object_score_logits = nn.mlp(p["pred_obj_score_head"], hs[:, 0],
                                         activation="relu")
        else:
            object_score_logits = nn.linear(p["pred_obj_score_head"],
                                            hs[:, 0])
    else:
        object_score_logits = 10.0 * iou_pred.new_ones((B, 1))
    return masks, iou_pred, mask_tokens_out, object_score_logits


def _stability_scores(cfg, mask_logits):
    flat = mask_logits.flatten(-2)
    d = cfg.dynamic_multimask_stability_delta
    area_i = (flat > d).sum(-1).float()
    area_u = (flat > -d).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp_min(1.0),
                       torch.ones_like(area_u))


def _dynamic_multimask_via_stability(cfg, all_mask_logits, all_iou_scores):
    """Eval-time fallback from the single-mask token to the best multimask
    token when the single mask is unstable."""
    multimask_logits = all_mask_logits[:, 1:]
    multimask_iou = all_iou_scores[:, 1:]
    best = torch.argmax(multimask_iou, dim=-1)
    bi = torch.arange(all_mask_logits.shape[0], device=best.device)
    best_logits = multimask_logits[bi, best][:, None]
    best_iou = multimask_iou[bi, best][:, None]
    single_logits = all_mask_logits[:, 0:1]
    single_iou = all_iou_scores[:, 0:1]
    stable = _stability_scores(cfg, single_logits) >= \
        cfg.dynamic_multimask_stability_thresh
    out_logits = torch.where(stable[..., None, None], single_logits,
                             best_logits)
    out_iou = torch.where(stable, single_iou, best_iou)
    return out_logits, out_iou


def apply(p, cfg: MaskDecoderConfig, image_embeddings, image_pe,
          sparse_prompt_embeddings, dense_prompt_embeddings,
          multimask_output: bool, high_res_features=None,
          training: bool = True):
    """Returns (masks [B, M, 4H, 4W], iou_pred [B, M], sam_tokens_out
    [B, 1|3, C], object_score_logits [B, 1]); M = 3 if multimask else 1."""
    masks, iou_pred, mask_tokens_out, object_score_logits = predict_masks(
        p, cfg, image_embeddings, image_pe, sparse_prompt_embeddings,
        dense_prompt_embeddings, high_res_features)
    if multimask_output:
        masks, iou_pred = masks[:, 1:], iou_pred[:, 1:]
    elif cfg.dynamic_multimask_via_stability and not training:
        masks, iou_pred = _dynamic_multimask_via_stability(cfg, masks,
                                                           iou_pred)
    else:
        masks, iou_pred = masks[:, 0:1], iou_pred[:, 0:1]
    if multimask_output and cfg.use_multimask_token_for_obj_ptr:
        sam_tokens_out = mask_tokens_out[:, 1:]
    else:
        sam_tokens_out = mask_tokens_out[:, 0:1]
    return masks, iou_pred, sam_tokens_out, object_score_logits
