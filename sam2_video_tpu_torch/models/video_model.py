"""Video training forward (counterpart of
``sam2_video_tpu/models/video_model.py``): prompt frame 0, then track
frames 1 .. T-1 over the memory bank.

Only the static-prefix unrolled loop is ported (remat_mode "none",
scan_unroll 0, the JAX package's default training path): frame t attends
its valid memory prefix (1 + min(t - 1, num_maskmem - 1) spatial slots and
1 + min(t - 1, P - 1) pointers, newest first), so no slot is masked. The
memory bank is cut with ``.detach()`` where the JAX package has
``stop_gradient`` (``detach_memory_bank``). The ``lax.scan`` /
rematerialised loop and ``stacked_frame_grads`` raise
``NotImplementedError`` (ROADMAP.md, queue 1, item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.types import VideoClip
from ..ops import common as nn
from ..utils.merging import merge_objects_to_categories
from . import memory_attention as memory_attention_mod
from . import sam2 as sam2_mod
from .sam2 import SAM2Config

SCAN_NOT_PORTED = (
    "the lax.scan / rematerialised frame loop (remat_mode other than "
    "'none', or scan_unroll > 0) is not ported: see ROADMAP.md, queue 1, "
    "item 4; build the config with use_activation_checkpoint=False")
STACKED_NOT_PORTED = (
    "stacked_frame_grads is not ported: see ROADMAP.md, queue 1, item 4")


@dataclasses.dataclass(frozen=True)
class VideoModelConfig:
    sam2: SAM2Config = dataclasses.field(default_factory=SAM2Config)
    prompt_type: str = "point"  # {point, box, mask}


def _use_multimask(cfg: SAM2Config, is_init: bool, num_pts: int) -> bool:
    """sam2_base.py:932-940, static."""
    return bool(
        cfg.multimask_output_in_sam
        and (is_init or cfg.multimask_output_for_tracking)
        and (cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num))


def _broadcast_obj(x: torch.Tensor, num_objects: int) -> torch.Tensor:
    """A single-frame tensor with a leading object axis."""
    return x[None].expand((num_objects,) + tuple(x.shape))


def forward_train(params, mcfg: VideoModelConfig, clip: VideoClip,
                  training: bool = True):
    """The tracking forward over one clip. ``params`` is a ParamTree or its
    nested dict (``ParamTree.tree()``, with derived entries). Returns
    (per_object_outs, per_category_outs): dicts of [T, O, ...] and
    [T, C, ...] (high_res_multimasks, ious, object_score_logits,
    high_res_masks)."""
    cfg = mcfg.sam2
    remat = cfg.resolved_remat_mode() if training else "none"
    if remat != "none" or cfg.scan_unroll != 0:
        raise NotImplementedError(SCAN_NOT_PORTED)
    if training and cfg.stacked_frame_grads:
        raise NotImplementedError(STACKED_NOT_PORTED)
    T, O = clip.num_frames, clip.num_objects
    HW, F, C = cfg.num_spatial_tokens, cfg.feat_size, cfg.d_model
    dev = clip.images.device

    # memory attention's permuted q/k projections, derived here from the
    # current weights (under autograd when they train)
    p = params.tree() if isinstance(params, nn.ParamTree) else dict(params)
    p["memory_attention"] = memory_attention_mod.prepare(
        params["memory_attention"], cfg.memory_attention_config)

    # ---- 1. image encoder on all frames
    backbone = sam2_mod.forward_image(p, cfg, clip.images)
    s0, s1, s16 = backbone["backbone_fpn"]
    curr_pos = backbone["vision_pos_enc"][2].reshape(HW, C)

    # ---- 2. frame 0: the prompted conditioning frame
    feats0 = _broadcast_obj(s16[0], O)
    hr0 = (_broadcast_obj(s0[0], O), _broadcast_obj(s1[0], O))
    no_mem = p["no_mem_embed"].reshape(1, 1, 1, C)
    if mcfg.prompt_type == "mask":
        mask_inputs0 = clip.obj_masks[..., None]
        if cfg.use_mask_input_as_output_without_sam and T > 1:
            out0 = sam2_mod.use_mask_as_output(p, cfg, feats0, hr0,
                                               mask_inputs0,
                                               training=training)
        else:
            out0 = sam2_mod.forward_sam_heads(
                p, cfg, feats0 + no_mem.to(feats0.dtype),
                mask_inputs=mask_inputs0, high_res_features=hr0,
                multimask_output=_use_multimask(cfg, True, 0),
                training=training)
    else:
        num_pts = clip.point_labels.shape[-1]
        out0 = sam2_mod.forward_sam_heads(
            p, cfg, feats0 + no_mem.to(feats0.dtype),
            point_coords=clip.point_coords, point_labels=clip.point_labels,
            high_res_features=hr0,
            multimask_output=_use_multimask(cfg, True, num_pts),
            training=training)

    cond_mem, mem_pos_grid = sam2_mod.encode_new_memory(
        p, cfg, feats0, out0["high_res_masks"], out0["object_score_logits"],
        training=training,
        apply_non_overlap=cfg.non_overlap_masks_for_mem_enc)

    def detach(x):
        return x.detach() if cfg.detach_memory_bank else x

    bank_dt = cfg.bank_dtype()
    cond_mem = detach(cond_mem.reshape(O, HW, cfg.mem_dim).to(bank_dt))
    mem_pos = mem_pos_grid.reshape(HW, cfg.mem_dim)
    cond_ptr = detach(out0["obj_ptr"].to(bank_dt))
    outs = [_loss_outputs(out0)]
    if T == 1:
        return _finalize({k: v[None] for k, v in outs[0].items()}, clip)

    # ---- 3. frames 1 .. T-1 over the valid memory prefix
    layout = sam2_mod.memory_layout(cfg, T)
    R = cfg.num_maskmem - 1
    Pn = max(layout.num_ptrs - 1, 0)
    mm_track = _use_multimask(cfg, False, 0)
    # the pointer tpos normaliser is the whole clip's pointer budget
    t_diff_max = max(layout.num_ptrs - 1, 1)
    mem_list, ptr_list = [], []
    for t in range(1, T):
        n_slots = min(t - 1, R)
        spatial_mem = torch.stack([cond_mem] + mem_list[:n_slots])
        tpos_index = torch.tensor([cfg.num_maskmem - 1] + list(range(n_slots)),
                                  dtype=torch.long, device=dev)
        if Pn > 0:
            n_ptr = min(t - 1, Pn)
            obj_ptrs = torch.stack([cond_ptr] + ptr_list[:n_ptr])
            ptr_tpos = torch.tensor([float(t)] + [float(i + 1)
                                                  for i in range(n_ptr)],
                                    dtype=torch.float32, device=dev)
            lay_ptrs = 1 + n_ptr
        else:
            obj_ptrs = torch.zeros((0, O, C), device=dev)
            ptr_tpos = torch.zeros((0,), device=dev)
            lay_ptrs = 0
        layout_t = sam2_mod.MemoryLayout(
            num_maskmem=1 + n_slots, tokens_per_slot=HW, num_ptrs=lay_ptrs,
            tokens_per_ptr=layout.tokens_per_ptr)

        curr = _broadcast_obj(s16[t].reshape(HW, C), O)
        fused = sam2_mod.fuse_memory(
            p, cfg, layout_t, curr, curr_pos, spatial_mem, None, mem_pos,
            tpos_index, obj_ptrs, None, ptr_tpos,
            t_diff_max=t_diff_max).reshape(O, F, F, C)
        hr = (_broadcast_obj(s0[t], O), _broadcast_obj(s1[t], O))
        out_t = sam2_mod.forward_sam_heads(
            p, cfg, fused, high_res_features=hr, multimask_output=mm_track,
            training=training)
        new_mem, _ = sam2_mod.encode_new_memory(
            p, cfg, _broadcast_obj(s16[t], O), out_t["high_res_masks"],
            out_t["object_score_logits"], training=training,
            apply_non_overlap=cfg.non_overlap_masks_for_mem_enc)
        new_mem = new_mem.reshape(O, HW, cfg.mem_dim).to(bank_dt)
        mem_list = [detach(new_mem)] + mem_list[:R - 1]
        if Pn > 0:
            ptr_list = [detach(out_t["obj_ptr"].to(bank_dt))] + \
                ptr_list[:Pn - 1]
        outs.append(_loss_outputs(out_t))

    per_obj = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return _finalize(per_obj, clip)


def _loss_outputs(out: dict) -> dict:
    """The per-frame keys the loss and eval read."""
    return {k: out[k] for k in ("high_res_multimasks", "ious",
                                "object_score_logits", "high_res_masks")}


def _finalize(per_obj: dict, clip: VideoClip):
    per_cat = merge_objects_to_categories(per_obj, clip.obj_to_cat,
                                          clip.cat_masks.shape[1])
    return per_obj, per_cat
