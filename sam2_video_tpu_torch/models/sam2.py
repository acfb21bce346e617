"""SAM2 core (counterpart of ``sam2_video_tpu/models/sam2.py``): the config,
the parameter tree, and the pieces of the tracking recurrence that the
streaming predictor drives: image encoding, the SAM heads, memory encoding
and memory fusion over a fixed-shape memory bank (invalid slots masked by
an additive attention bias)."""

from __future__ import annotations

import dataclasses

import torch

from ..data.coco import IMAGENET_MEAN, IMAGENET_STD
from ..ops import common as nn
from ..ops.position_encoding import sine_pe_1d
from ..ops.resize import resize_bilinear
from . import image_encoder as image_encoder_mod
from . import mask_decoder as mask_decoder_mod
from . import memory_attention as memory_attention_mod
from . import memory_encoder as memory_encoder_mod
from . import prompt_encoder as prompt_encoder_mod
from .hiera import HIERA_PRESETS, HieraConfig

NO_OBJ_SCORE = -1024.0


# Named sub-modules for freezing / fine-tuning combos (the JAX package's
# MODULE_MAPPING, sam2model.py:550-565 of the reference).
MODULE_MAPPING = {
    "image_encoder": ("image_encoder",),
    "memory_attention": ("memory_attention",),
    "memory_encoder": ("memory_encoder",),
    "prompt_encoder": ("sam_prompt_encoder",),
    "mask_decoder": ("sam_mask_decoder",),
    "obj_ptr_proj": ("obj_ptr_proj",),
    "obj_ptr_tpos_proj": ("obj_ptr_tpos_proj",),
}


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """The same fields and defaults as the JAX package's SAM2Config (SAM2.1
    defaults from sam2.1_hiera_t.yaml). Training-only knobs are carried so
    one config describes both packages."""

    backbone: str = "tiny"
    image_size: int = 384
    backbone_stride: int = 16
    d_model: int = 256
    mem_dim: int = 64

    num_maskmem: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = False
    use_mask_input_as_output_without_sam: bool = True
    max_cond_frames_in_attn: int = -1
    directly_add_no_mem_embed: bool = True
    memory_temporal_stride_for_eval: int = 1
    non_overlap_masks_for_mem_enc: bool = False

    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = True
    proj_tpos_enc_in_obj_ptrs: bool = True
    use_signed_tpos_enc_to_obj_ptrs: bool = True
    only_obj_ptrs_in_the_past_for_eval: bool = True

    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = False
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = False
    use_multimask_token_for_obj_ptr: bool = False
    iou_prediction_use_sigmoid: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    no_obj_embed_spatial: bool = True
    dynamic_multimask_via_stability: bool = True

    use_activation_checkpoint: bool = True
    remat_mode: str = ""
    compute_dtype: str = "bfloat16"
    use_flash_attention: bool = True
    scan_unroll: int = 0
    stacked_frame_grads: bool = False
    memory_bank_dtype: str = "float32"
    detach_memory_bank: bool = True
    fused_backbone_vjp: bool = False
    # The two-way decoder blocks through kernel #8: the JAX package's
    # MaskDecoderConfig.fused_twoway, which its SAM2Config does not forward
    # (its decoder reaches the kernel only when called with its own
    # config). Off by default as there, so every path computes what it did.
    fused_twoway: bool = False

    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    def bank_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.memory_bank_dtype == "bfloat16"
                else torch.float32)

    def resolved_remat_mode(self) -> str:
        if self.remat_mode:
            return self.remat_mode
        return "body" if self.use_activation_checkpoint else "none"

    @property
    def trunk_config(self) -> HieraConfig:
        return HIERA_PRESETS[self.backbone]

    @property
    def image_encoder_config(self) -> image_encoder_mod.ImageEncoderConfig:
        return image_encoder_mod.ImageEncoderConfig(
            trunk=self.trunk_config, d_model=self.d_model, scalp=1,
            fpn_top_down_levels=(2, 3), num_pos_feats=self.d_model)

    @property
    def feat_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def num_spatial_tokens(self) -> int:
        return self.feat_size * self.feat_size

    @property
    def prompt_encoder_config(self) -> prompt_encoder_mod.PromptEncoderConfig:
        return prompt_encoder_mod.PromptEncoderConfig(
            embed_dim=self.d_model,
            image_embedding_size=(self.feat_size, self.feat_size),
            input_image_size=(self.image_size, self.image_size),
            mask_in_chans=16)

    @property
    def mask_decoder_config(self) -> mask_decoder_mod.MaskDecoderConfig:
        c = self
        return mask_decoder_mod.MaskDecoderConfig(
            transformer_dim=c.d_model,
            use_high_res_features=c.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=c.iou_prediction_use_sigmoid,
            pred_obj_scores=c.pred_obj_scores,
            pred_obj_scores_mlp=c.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=c.use_multimask_token_for_obj_ptr,
            dynamic_multimask_via_stability=c.dynamic_multimask_via_stability,
            fused_twoway=c.fused_twoway)

    @property
    def memory_attention_config(
            self) -> memory_attention_mod.MemoryAttentionConfig:
        return memory_attention_mod.MemoryAttentionConfig(
            d_model=self.d_model, kv_in_dim=self.mem_dim,
            use_flash=self.use_flash_attention)

    @property
    def memory_encoder_config(self) -> memory_encoder_mod.MemoryEncoderConfig:
        return memory_encoder_mod.MemoryEncoderConfig(
            out_dim=self.mem_dim, in_dim=self.d_model)

    @property
    def ptr_tokens_per_obj(self) -> int:
        return self.d_model // self.mem_dim


def init(cfg: SAM2Config, seed: int = 0) -> nn.ParamTree:
    """Random parameters from a seeded ``torch.Generator``, with the JAX
    package's names and shapes in torch layout (float32, on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    p = {
        "image_encoder": image_encoder_mod.init(gen, cfg.image_encoder_config),
        "memory_attention": memory_attention_mod.init(
            gen, cfg.memory_attention_config),
        "memory_encoder": memory_encoder_mod.init(
            gen, cfg.memory_encoder_config),
        "sam_prompt_encoder": prompt_encoder_mod.init(
            gen, cfg.prompt_encoder_config),
        "sam_mask_decoder": mask_decoder_mod.init(gen,
                                                  cfg.mask_decoder_config),
        "maskmem_tpos_enc": nn.trunc_normal(
            gen, (cfg.num_maskmem, 1, 1, cfg.mem_dim)),
        "no_mem_embed": nn.trunc_normal(gen, (1, 1, cfg.d_model)),
        "no_mem_pos_enc": nn.trunc_normal(gen, (1, 1, cfg.d_model)),
    }
    if cfg.use_obj_ptrs_in_encoder:
        p["mask_downsample"] = nn.conv2d_init(gen, 1, 1, 4)
        if cfg.use_mlp_for_obj_ptr_proj:
            p["obj_ptr_proj"] = nn.mlp_init(gen, cfg.d_model, cfg.d_model,
                                            cfg.d_model, 3)
        else:
            p["obj_ptr_proj"] = nn.linear_init(gen, cfg.d_model, cfg.d_model)
    if cfg.pred_obj_scores and cfg.use_obj_ptrs_in_encoder:
        p["no_obj_ptr"] = nn.trunc_normal(gen, (1, cfg.d_model))
    if cfg.proj_tpos_enc_in_obj_ptrs:
        p["obj_ptr_tpos_proj"] = nn.linear_init(gen, cfg.d_model, cfg.mem_dim)
    if cfg.no_obj_embed_spatial:
        p["no_obj_embed_spatial"] = nn.trunc_normal(gen, (1, cfg.mem_dim))
    return nn.ParamTree(p)


def prepare(p: nn.ParamTree, cfg: SAM2Config) -> nn.ParamTree:
    """A tree over the same parameter tensors plus the entries derived from
    them once, where the predictor is built (the JAX package's ``prepare``):
    memory attention's permuted q/k projections, the kernels' packed
    operands (``_ops``) and, for a compute dtype other than float32, every
    product's weight and bias in that dtype (``ops/common.py``
    ``add_compute_casts``). ``p`` itself is left as it was. Derived
    entries do not follow a later ``.to`` or change of the parameters:
    prepare the tree again after either."""
    tree = p.tree()
    tree["memory_attention"] = memory_attention_mod.prepare(
        p["memory_attention"], cfg.memory_attention_config)
    return nn.ParamTree(derive(tree, cfg))


def derive(tree: dict, cfg: SAM2Config, modules=None) -> dict:
    """Add the derived entries of the top-level ``modules`` (all when None)
    to the nested dict ``tree`` in place: the kernels' packed operands
    (the trunk's and memory encoder's, and the decoder blocks' with
    ``cfg.fused_twoway``), made without gradient, and the compute-dtype
    casts, made under autograd. The train step derives its frozen modules
    once and its trainable ones in every step. With
    ``cfg.fused_backbone_vjp`` (a trainable trunk) the trunk's blocks get
    no compute-dtype casts: their trainable kernel takes the float32
    leaves, whose gradients it returns, and reads the packed operands, made
    here once per step, as data; #8 reads its pack beside a trainable
    decoder's float32 leaves the same way."""
    from ..ops import hiera_block_kernel as hbk
    from ..ops import memory_encoder_kernel as mek
    from ..ops import twoway_kernel as twk

    def want(top):
        return top in tree and (modules is None or top in modules)

    trunk_vjp = cfg.fused_backbone_vjp and want("image_encoder")
    with torch.no_grad():
        if want("image_encoder"):
            blocks = tree["image_encoder"]["trunk"]["blocks"]
            for i, spec in enumerate(cfg.trunk_config.block_specs()):
                blocks[str(i)]["_ops"] = hbk.pack(blocks[str(i)], spec)
        if want("memory_encoder") and mek.eligible(cfg.memory_encoder_config):
            tree["memory_encoder"]["_ops"] = mek.pack(
                tree["memory_encoder"], cfg.memory_encoder_config)
        if want("sam_mask_decoder") and cfg.fused_twoway:
            for layer in tree["sam_mask_decoder"]["transformer"][
                    "layers"].values():
                layer["_ops"] = twk.pack(layer)
    if cfg.dtype() != torch.float32:
        for top, sub in tree.items():
            if not (want(top) and isinstance(sub, dict)):
                continue
            if top == "image_encoder" and trunk_vjp:
                trunk = sub["trunk"]
                nn.add_compute_casts(trunk["patch_embed"], cfg.dtype())
                nn.add_compute_casts(sub["neck"], cfg.dtype())
            else:
                nn.add_compute_casts(sub, cfg.dtype())
    return tree


# ---------------------------------------------------------------------------
# Image encoding
# ---------------------------------------------------------------------------


def forward_image(p, cfg: SAM2Config, images: torch.Tensor):
    """images [B, H, W, 3], uint8 (normalised here) or float32 already
    ImageNet-normalised -> dict(backbone_fpn=[s0, s1, s16], vision_pos_enc),
    with levels 0/1 projected by the decoder's conv_s0/conv_s1. The trunk
    is routed by ``cfg.fused_backbone_vjp`` (the JAX package's routing):
    set (a trainable image encoder), every block runs the trainable block,
    kernel #1 forward and kernel #6 backward; unset (eval, a frozen image
    encoder), the forward-only block kernel."""
    if images.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
        std = torch.as_tensor(IMAGENET_STD, device=images.device)
        images = (images.float() / 255.0 - mean) / std
    images = images.to(cfg.dtype())
    out = image_encoder_mod.apply(p["image_encoder"], images,
                                  cfg.image_encoder_config,
                                  fused_vjp=cfg.fused_backbone_vjp)
    fpn = list(out["backbone_fpn"])
    if cfg.use_high_res_features_in_sam:
        fpn[0] = nn.conv2d(p["sam_mask_decoder"]["conv_s0"], fpn[0])
        fpn[1] = nn.conv2d(p["sam_mask_decoder"]["conv_s1"], fpn[1])
    return {"backbone_fpn": fpn, "vision_pos_enc": out["vision_pos_enc"]}


# ---------------------------------------------------------------------------
# SAM heads
# ---------------------------------------------------------------------------


def forward_sam_heads(p, cfg: SAM2Config, backbone_features,
                      point_coords=None, point_labels=None, mask_inputs=None,
                      high_res_features=None, multimask_output=False,
                      training=True):
    """Prompt encoding + mask decoding (sam2_base.py:262-434).

    backbone_features [B, H16, W16, C]; point_coords/labels [B, P, 2]/[B, P]
    or None; mask_inputs [B, H, W, 1] or None; high_res_features
    (s0, s1) projected. Returns the dict of the JAX function."""
    pe_cfg = cfg.prompt_encoder_config
    md_cfg = cfg.mask_decoder_config
    B = backbone_features.shape[0]
    dev = backbone_features.device
    dt = cfg.dtype()

    if point_coords is None:
        point_coords = torch.zeros((B, 1, 2), device=dev)
        point_labels = -torch.ones((B, 1), dtype=torch.int32, device=dev)

    if mask_inputs is not None:
        target_hw = (4 * cfg.feat_size, 4 * cfg.feat_size)
        m = mask_inputs.float()
        if tuple(mask_inputs.shape[1:3]) != target_hw:
            m = resize_bilinear(m.permute(0, 3, 1, 2), target_hw)
            m = m.permute(0, 2, 3, 1)
        dense = prompt_encoder_mod.embed_masks(p["sam_prompt_encoder"],
                                               m.to(dt))
    else:
        dense = prompt_encoder_mod.no_mask_dense(
            p["sam_prompt_encoder"], pe_cfg, B).to(dt)

    sparse = prompt_encoder_mod.embed_points(
        p["sam_prompt_encoder"], pe_cfg, point_coords, point_labels,
        pad=True).to(dt)
    image_pe = prompt_encoder_mod.get_dense_pe(p["sam_prompt_encoder"],
                                               pe_cfg)
    hrf = (tuple(high_res_features) if cfg.use_high_res_features_in_sam
           else None)
    low_res_multimasks, ious, sam_output_tokens, object_score_logits = \
        mask_decoder_mod.apply(
            p["sam_mask_decoder"], md_cfg, backbone_features.to(dt),
            image_pe, sparse, dense, multimask_output=multimask_output,
            high_res_features=hrf, training=training)

    if cfg.pred_obj_scores:
        is_obj_appearing = object_score_logits > 0               # [B, 1]
        low_res_multimasks = torch.where(
            is_obj_appearing[..., None, None], low_res_multimasks,
            torch.full_like(low_res_multimasks, NO_OBJ_SCORE))

    low_res_multimasks = low_res_multimasks.float()
    high_res_multimasks = resize_bilinear(low_res_multimasks,
                                          (cfg.image_size, cfg.image_size))

    sam_output_token = sam_output_tokens[:, 0]
    if multimask_output:
        best = torch.argmax(ious, dim=-1)
        bi = torch.arange(B, device=dev)
        low_res_masks = low_res_multimasks[bi, best][:, None]
        high_res_masks = high_res_multimasks[bi, best][:, None]
        if sam_output_tokens.shape[1] > 1:
            sam_output_token = sam_output_tokens[bi, best]
    else:
        low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks

    if cfg.use_obj_ptrs_in_encoder:
        if cfg.use_mlp_for_obj_ptr_proj:
            obj_ptr = nn.mlp(p["obj_ptr_proj"], sam_output_token,
                             activation="relu")
        else:
            obj_ptr = nn.linear(p["obj_ptr_proj"], sam_output_token)
    else:
        obj_ptr = sam_output_token
    if cfg.pred_obj_scores:
        lam = (torch.sigmoid(object_score_logits) if cfg.soft_no_obj_ptr
               else is_obj_appearing.to(obj_ptr.dtype))
        if cfg.fixed_no_obj_ptr:
            obj_ptr = lam * obj_ptr
        obj_ptr = obj_ptr + (1.0 - lam) * p["no_obj_ptr"].to(obj_ptr.dtype)

    return {
        "low_res_multimasks": low_res_multimasks,
        "high_res_multimasks": high_res_multimasks,
        "ious": ious.float(),
        "low_res_masks": low_res_masks,
        "high_res_masks": high_res_masks,
        "obj_ptr": obj_ptr.float(),
        "object_score_logits": object_score_logits.float(),
    }


def use_mask_as_output(p, cfg: SAM2Config, backbone_features,
                       high_res_features, mask_inputs, training=True):
    """Binary mask inputs [B, H, W, 1] at image resolution become output
    logits directly, bypassing the SAM head (sam2_base.py:436-486)."""
    out_scale, out_bias = 20.0, -10.0
    mask_f = mask_inputs.float()
    high_res_masks = mask_f.permute(0, 3, 1, 2) * out_scale + out_bias
    low_res_masks = resize_bilinear(
        high_res_masks,
        (high_res_masks.shape[-2] // 4, high_res_masks.shape[-1] // 4))
    B = mask_inputs.shape[0]
    ious = mask_f.new_ones((B, 1))
    if not cfg.use_obj_ptrs_in_encoder:
        obj_ptr = mask_f.new_zeros((B, cfg.d_model))
    else:
        ds_mask = nn.conv2d(p["mask_downsample"], mask_f.to(cfg.dtype()),
                            stride=4)
        head_out = forward_sam_heads(
            p, cfg, backbone_features, mask_inputs=ds_mask,
            high_res_features=high_res_features, training=training)
        obj_ptr = head_out["obj_ptr"]
    is_obj_appearing = (mask_f.reshape(B, -1) > 0.0).any(dim=1)[
        ..., None].float()
    object_score_logits = out_scale * is_obj_appearing + out_bias
    if cfg.pred_obj_scores:
        if cfg.fixed_no_obj_ptr:
            obj_ptr = is_obj_appearing * obj_ptr
        obj_ptr = obj_ptr + (1.0 - is_obj_appearing) * p["no_obj_ptr"]
    return {
        "low_res_multimasks": low_res_masks,
        "high_res_multimasks": high_res_masks,
        "ious": ious,
        "low_res_masks": low_res_masks,
        "high_res_masks": high_res_masks,
        "obj_ptr": obj_ptr.float(),
        "object_score_logits": object_score_logits,
    }


# ---------------------------------------------------------------------------
# Memory encoding
# ---------------------------------------------------------------------------


def encode_new_memory(p, cfg: SAM2Config, pix_feat, high_res_masks,
                      object_score_logits, training=False,
                      apply_non_overlap=False):
    """pix_feat [B, H16, W16, C] (raw backbone); high_res_masks
    [B, 1, H, W] logits. Returns (mem [B, H16, W16, mem_dim],
    pos [H16, W16, mem_dim]). The encoder runs through the memory-encoder
    kernel's wrapper, forward-only, at eval and in training when the bank
    is detached (its output's only consumer), under ``torch.no_grad``; as
    in the JAX package (``allow_fused``), training through an attached bank
    takes the plain, differentiable path, for which there is no kernel."""
    if apply_non_overlap and not training:
        high_res_masks = apply_non_overlapping_constraints(high_res_masks)
    mask_for_mem = torch.sigmoid(high_res_masks)
    mask_for_mem = (mask_for_mem * cfg.sigmoid_scale_for_mem_enc
                    + cfg.sigmoid_bias_for_mem_enc)
    mask_nhwc = mask_for_mem.permute(0, 2, 3, 1).to(cfg.dtype())
    forward_only = (not training) or cfg.detach_memory_bank
    with torch.set_grad_enabled(torch.is_grad_enabled() and not forward_only):
        mem, pos = memory_encoder_mod.apply(
            p["memory_encoder"], cfg.memory_encoder_config,
            pix_feat.to(cfg.dtype()), mask_nhwc, allow_fused=forward_only)
    if cfg.no_obj_embed_spatial:
        is_obj = (object_score_logits > 0).to(mem.dtype)          # [B, 1]
        mem = mem + (1.0 - is_obj[:, :, None, None]) * \
            p["no_obj_embed_spatial"].to(mem.dtype).reshape(1, 1, 1, -1)
    return mem, pos


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object per pixel. [B_obj, 1, H, W]."""
    batch_size = pred_masks.shape[0]
    if batch_size == 1:
        return pred_masks
    max_obj = torch.argmax(pred_masks, dim=0, keepdim=True)
    keep = max_obj == torch.arange(
        batch_size, device=pred_masks.device)[:, None, None, None]
    return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))


# ---------------------------------------------------------------------------
# Memory-conditioned features (fixed-shape memory bank)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryLayout:
    """Static geometry of the fused memory sequence."""
    num_maskmem: int          # spatial slots incl. conditioning slot
    tokens_per_slot: int      # H16*W16
    num_ptrs: int             # pointer slots incl. conditioning pointer
    tokens_per_ptr: int       # d_model // mem_dim

    @property
    def num_spatial_tokens(self) -> int:
        return self.num_maskmem * self.tokens_per_slot


def memory_layout(cfg: SAM2Config, num_frames: int) -> MemoryLayout:
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    return MemoryLayout(
        num_maskmem=cfg.num_maskmem, tokens_per_slot=cfg.num_spatial_tokens,
        num_ptrs=max_ptrs if cfg.use_obj_ptrs_in_encoder else 0,
        tokens_per_ptr=cfg.ptr_tokens_per_obj)


def fuse_memory(p, cfg: SAM2Config, layout: MemoryLayout,
                curr_feat, curr_pos, spatial_mem, spatial_valid,
                mem_pos_spatial, tpos_index, obj_ptrs, ptr_valid, ptr_tpos,
                t_diff_max=None):
    """Memory attention over the fixed-shape bank.

    curr_feat [O, HW, C]; curr_pos [HW, C]; spatial_mem [M, O, HW, mem_dim]
    (slot 0 the conditioning frame); spatial_valid [M] bool or None;
    mem_pos_spatial [HW, mem_dim]; tpos_index [M] long; obj_ptrs [P, O, C];
    ptr_valid [P] bool or None; ptr_tpos [P] float. Returns [O, HW, C]."""
    M, O, HW, mem_dim = spatial_mem.shape
    C = cfg.d_model
    dt = cfg.dtype()

    tpos = p["maskmem_tpos_enc"][tpos_index][:, 0]        # [M, 1, mem_dim]
    mem_pos = (mem_pos_spatial[None] + tpos)[:, None].expand(
        M, O, HW, mem_dim)
    memory = spatial_mem.permute(1, 0, 2, 3).reshape(O, M * HW, mem_dim)
    memory_pos = mem_pos.permute(1, 0, 2, 3).reshape(O, M * HW, mem_dim)
    token_valid = (spatial_valid.repeat_interleave(HW)
                   if spatial_valid is not None else None)

    if layout.num_ptrs > 0:
        P, tpp = layout.num_ptrs, layout.tokens_per_ptr
        if t_diff_max is None:
            t_diff_max = max(P - 1, 1)
        if cfg.add_tpos_enc_to_obj_ptrs:
            tdim = C if cfg.proj_tpos_enc_in_obj_ptrs else cfg.mem_dim
            pos1d = sine_pe_1d(ptr_tpos / t_diff_max, tdim)
            if cfg.proj_tpos_enc_in_obj_ptrs:
                pos1d = nn.linear(p["obj_ptr_tpos_proj"], pos1d)
        else:
            pos1d = curr_feat.new_zeros((P, cfg.mem_dim), dtype=torch.float32)
        ptr_tok = obj_ptrs.permute(1, 0, 2).reshape(O, P * tpp, mem_dim)
        ptr_pos = pos1d.repeat_interleave(tpp, dim=0)[None].expand(
            O, P * tpp, mem_dim)
        memory = torch.cat([memory, ptr_tok.to(memory.dtype)], dim=1)
        memory_pos = torch.cat([memory_pos, ptr_pos.to(memory_pos.dtype)],
                               dim=1)
        if token_valid is not None or ptr_valid is not None:
            dev = curr_feat.device
            token_valid = torch.cat([
                (token_valid if token_valid is not None else torch.ones(
                    layout.num_spatial_tokens, dtype=torch.bool, device=dev)),
                (ptr_valid.repeat_interleave(tpp) if ptr_valid is not None
                 else torch.ones(P * tpp, dtype=torch.bool, device=dev))])

    return memory_attention_mod.apply(
        p["memory_attention"], cfg.memory_attention_config,
        curr_feat.to(dt), memory.to(dt), curr_pos[None].to(dt),
        memory_pos.to(dt), feat_hw=(cfg.feat_size, cfg.feat_size),
        num_spatial_k=layout.num_spatial_tokens, key_valid=token_valid)
