"""Video training forward (counterpart of
``sam2_video_tpu/models/video_model.py``): prompt frame 0, then track
frames 1 .. T-1 over the memory bank. The memory bank is cut with
``.detach()`` where the JAX package has ``stop_gradient``
(``detach_memory_bank``).

One frame loop, for every rematerialisation mode: frame t attends its
valid memory prefix (1 + min(t - 1, num_maskmem - 1) spatial slots and
1 + min(t - 1, P - 1) pointers, newest first), so no slot is masked.

- "modules" checkpoints the mask decoder, memory encoder and memory
  attention one by one (``models/sam2.py`` ``remat``).
- "body" runs each tracked frame's body (memory fusion, SAM heads, memory
  encoding) under one non-reentrant activation checkpoint, with the
  per-module checkpoints off inside it (nested, they would recompute
  twice); frame 0 keeps them.
- "body_dots" is "body" under a selective checkpoint that keeps the
  outputs of ``aten.mm`` / ``aten.addmm`` (``DOTS_SAVED``, the counterpart
  of JAX's ``dots_with_no_batch_dims_saveable``) and recomputes the rest:
  batched products and convolutions, and the hand-written kernels, which
  run through ctypes and which the policy never sees.
- ``stacked_frame_grads`` gives each tracked frame its own view of every
  parameter outside the image encoder (``a.expand(T - 1, ...).unbind(0)``):
  the forward is unchanged, and each weight's frame gradients are stacked
  once and summed once instead of accumulated frame by frame.

The JAX package runs "body" and "body_dots" (and ``scan_unroll > 0``) as a
``lax.scan`` over fixed-shape ring buffers, every frame attending the
whole ring with its invalid slots masked by a -1e9 key bias. That shape
is a constraint of ``lax.scan``, not of the model: a masked key adds an
exact zero, so the prefix gives the same numbers, and a Python loop needs
no fixed shape. ``scan_unroll`` is accepted and changes nothing here.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..data.types import VideoClip
from ..ops import common as nn
from ..utils.merging import merge_objects_to_categories
from . import memory_attention as memory_attention_mod
from . import sam2 as sam2_mod
from .sam2 import SAM2Config

# the products whose outputs "body_dots" keeps. Not aten.empty: the
# kernels allocate their outputs with it and write into them, so a kept
# buffer would be overwritten on the recompute.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


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


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _frame_views(tree: dict, n: int) -> list:
    """``n`` trees over ``tree`` (a nested dict) in which every tensor
    outside the image encoder that requires grad is one slice of
    ``a.expand(n, *a.shape).unbind(0)``: the same values, a gradient
    stacked over the n uses and summed once."""
    def views(x):
        if isinstance(x, dict):
            sub = {k: views(v) for k, v in x.items()}
            return [{k: v[i] for k, v in sub.items()} for i in range(n)]
        if isinstance(x, torch.Tensor) and x.requires_grad:
            return list(x.expand(n, *x.shape).unbind(0))
        return [x] * n

    heads = views({k: v for k, v in tree.items() if k != "image_encoder"})
    return [{**tree, **h} for h in heads]


def forward_train(params, mcfg: VideoModelConfig, clip: VideoClip,
                  training: bool = True):
    """The tracking forward over one clip. ``params`` is a ParamTree or its
    nested dict (``ParamTree.tree()``, with derived entries). Returns
    (per_object_outs, per_category_outs): dicts of [T, O, ...] and
    [T, C, ...] (high_res_multimasks, ious, object_score_logits,
    high_res_masks)."""
    cfg = mcfg.sam2
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

    # ---- 3. frames 1 .. T-1
    layout = sam2_mod.memory_layout(cfg, T)
    R = cfg.num_maskmem - 1
    Pn = max(layout.num_ptrs - 1, 0)
    mm_track = _use_multimask(cfg, False, 0)
    # the pointer tpos normaliser is the whole clip's pointer budget
    t_diff_max = max(layout.num_ptrs - 1, 1)
    remat_mode = cfg.resolved_remat_mode() if training else "none"
    body_cfg = (dataclasses.replace(cfg, use_activation_checkpoint=False,
                                    remat_mode="none")
                if remat_mode in ("body", "body_dots") else cfg)

    def frame_step(fp, layout_t, t, spatial_mem, tpos_index, obj_ptrs,
                   ptr_tpos):
        """One tracked frame: fuse memory, SAM heads, encode new memory."""
        curr = _broadcast_obj(s16[t].reshape(HW, C), O)
        fused = sam2_mod.fuse_memory(
            fp, body_cfg, layout_t, curr, curr_pos, spatial_mem, None,
            mem_pos, tpos_index, obj_ptrs, None, ptr_tpos,
            t_diff_max=t_diff_max, training=training).reshape(O, F, F, C)
        hr = (_broadcast_obj(s0[t], O), _broadcast_obj(s1[t], O))
        out_t = sam2_mod.forward_sam_heads(
            fp, body_cfg, fused, high_res_features=hr,
            multimask_output=mm_track, training=training)
        new_mem, _ = sam2_mod.encode_new_memory(
            fp, body_cfg, _broadcast_obj(s16[t], O), out_t["high_res_masks"],
            out_t["object_score_logits"], training=training,
            apply_non_overlap=cfg.non_overlap_masks_for_mem_enc)
        new_mem = new_mem.reshape(O, HW, cfg.mem_dim).to(bank_dt)
        return new_mem, out_t["obj_ptr"].to(bank_dt), _loss_outputs(out_t)

    step = frame_step
    if remat_mode in ("body", "body_dots"):
        context = (functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy)
                   if remat_mode == "body_dots"
                   else torch.utils.checkpoint.noop_context_fn)

        def step(*args):
            return checkpoint(frame_step, *args, use_reentrant=False,
                              preserve_rng_state=False, context_fn=context)

    # the bank as lists, newest first, so slot j holds the frame j + 1
    # steps back and the tpos index is j
    frame_p = (_frame_views(p, T - 1) if training and cfg.stacked_frame_grads
               else [p] * (T - 1))
    mem_list, ptr_list = [], []
    for t in range(1, T):
        n_slots = min(t - 1, R)
        spatial_mem = torch.stack([cond_mem] + mem_list[:n_slots])
        tpos_index = torch.tensor(
            [cfg.num_maskmem - 1] + list(range(n_slots)),
            dtype=torch.long, device=dev)
        if Pn > 0:
            n_ptr = min(t - 1, Pn)
            obj_ptrs = torch.stack([cond_ptr] + ptr_list[:n_ptr])
            ptr_tpos = torch.tensor(
                [float(t)] + [float(i + 1) for i in range(n_ptr)],
                dtype=torch.float32, device=dev)
            lay_ptrs = 1 + n_ptr
        else:
            obj_ptrs = torch.zeros((0, O, C), device=dev)
            ptr_tpos = torch.zeros((0,), device=dev)
            lay_ptrs = 0
        layout_t = sam2_mod.MemoryLayout(
            num_maskmem=1 + n_slots, tokens_per_slot=HW,
            num_ptrs=lay_ptrs, tokens_per_ptr=layout.tokens_per_ptr)
        new_mem, new_ptr, outs_t = step(frame_p[t - 1], layout_t, t,
                                        spatial_mem, tpos_index, obj_ptrs,
                                        ptr_tpos)
        mem_list = [detach(new_mem)] + mem_list[:R - 1]
        if Pn > 0:
            ptr_list = [detach(new_ptr)] + ptr_list[:Pn - 1]
        outs.append(outs_t)

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
