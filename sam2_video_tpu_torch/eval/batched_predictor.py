"""Lockstep batched video propagation (counterpart of
``sam2_video_tpu/eval/batched_predictor.py``): track a group of G clips of
one shape at once.

The sequential ``VideoPredictor`` runs one device step and one host fetch
per frame per clip; eval on the card is bound by that host work. This
predictor steps all G clips together: one encode of the G x T frames, one
tracking step and one fetch of the group's low-res logits and scores per
lockstep frame.

A group shares the frame count, the original resolution, the single prompt
frame and the propagation direction (what the reference's fixed
``clip_length`` scheduler produces). Memory-slot selection (the eval
r-stride rule, sam2_base.py:565-595) then picks the same frame indices for
every video, so the selection is made once per frame on the host and only
the slot contents carry the group.

Where the JAX package maps one video's step over the group with
``jax.vmap``, here the group is folded into the object axis: every device
step runs [G * O, ...] rows through ``fuse_memory``, ``forward_sam_heads``
and ``encode_new_memory``, which work per object row. The one operation
across a frame's objects, ``apply_non_overlapping_constraints`` (with
``non_overlap_masks_for_mem_enc``), runs per video on a [G, O, ...] view
(``eval/predictor.py`` ``non_overlap_per_video``), so one video's masks
never suppress another's. The sequential predictor is the case G = 1 of
the same steps (``FrameSteps``).

Numerics equal the sequential predictor's row for row when the videos'
point prompts pad to the same count; clips that fit no group run on the
sequential predictor in the runner (``eval/inference.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..data import image_io
from ..models import sam2 as sam2_mod
from ..models.sam2 import SAM2Config
from .predictor import (CondOutput, FrameSteps, TrackedOutput,
                        _use_multimask, point_prompt, resize_frames)


@dataclasses.dataclass
class GroupState:
    group_size: int
    num_frames: int
    orig_hw: tuple[int, int]
    feats: tuple            # (s0 [G, T, ...], s1, s16) on the device
    prompts: list           # per video: {obj_id: payload}
    obj_order: list         # per video: [obj_id, ...]
    cond_frame_idx: int | None = None   # the shared prompt frame
    cond_outputs: dict | None = None    # {prompt frame: CondOutput} of the
                                        # group's [G * O, ...] rows
    mem_bank: dict | None = None        # frame -> TrackedOutput (mem, ptr)


class BatchedVideoPredictor(FrameSteps):
    """The sequential predictor's API over a group of G clips, with one
    conditioning frame per group (the reference clip schedulers' contract);
    interactive flows use ``VideoPredictor``. ``params`` as for
    ``VideoPredictor``. The device steps, the memory fusion and the slot
    selection are ``FrameSteps``', over the group's [G * O] rows."""

    def __init__(self, params, cfg: SAM2Config, max_objects: int = 8,
                 group_size: int = 4, encode_chunk: int = 8,
                 device: str | torch.device = "cuda"):
        super().__init__(params, cfg, max_objects, encode_chunk, 1, device,
                         group_size=group_size)
        self.group_size = group_size

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """Per-video [G, ...] -> per-row [G * O, ...]: each video's tensor
        repeated for its O object rows."""
        return x.repeat_interleave(self.max_objects, dim=0)

    @staticmethod
    def _fetch(packed: torch.Tensor, score: torch.Tensor):
        """The group's logits and scores in one device-to-host copy (the
        float32 scores first, so both views are aligned)."""
        flat = torch.cat([score.reshape(-1).view(torch.uint8),
                          packed.reshape(-1).view(torch.uint8)]).cpu().numpy()
        n = score.numel() * score.element_size()
        return (flat[n:].view(np.float16).reshape(packed.shape),
                flat[:n].view(np.float32).reshape(score.shape))

    # -- public API ---------------------------------------------------------

    def init_group(self, frames: np.ndarray) -> GroupState:
        """frames [G, T, H, W, 3] uint8: the group's clips, of one
        resolution and length (grouped on the host by the runner)."""
        G, T, H, W, _ = frames.shape
        if G != self.group_size:
            raise ValueError(f"group has {G} videos, predictor was built "
                             f"for group_size={self.group_size}")
        S = self.cfg.image_size
        flat = frames.reshape(G * T, H, W, 3)
        chunks = []
        with torch.no_grad():
            for i in range(0, G * T, self.encode_chunk):
                raw = torch.from_numpy(np.ascontiguousarray(
                    flat[i: i + self.encode_chunk])).to(self.device)
                out = sam2_mod.forward_image(self.params, self.cfg,
                                             resize_frames(raw, S))
                chunks.append(out["backbone_fpn"])
        feats = tuple(torch.cat([c[j] for c in chunks]).reshape(
            (G, T) + tuple(chunks[0][j].shape[1:])) for j in range(3))
        return GroupState(group_size=G, num_frames=T, orig_hw=(H, W),
                          feats=feats, prompts=[{} for _ in range(G)],
                          obj_order=[[] for _ in range(G)])

    def add_new_points_or_box(self, state: GroupState, video_idx: int,
                              frame_idx: int, obj_id, points=None,
                              labels=None, box=None):
        self._add(state, video_idx, frame_idx, obj_id, point_prompt(
            points, labels, box, state.orig_hw, self.cfg.image_size))

    def add_new_mask(self, state: GroupState, video_idx: int, frame_idx: int,
                     obj_id, mask: np.ndarray):
        """Binary mask at the video resolution, resized to image_size as
        Pillow's BILINEAR does (``data/image_io.py``) and re-binarised."""
        s = self.cfg.image_size
        m = (np.asarray(mask) > 0).astype(np.uint8) * 255
        m = image_io.resize_bilinear(m, (s, s))
        self._add(state, video_idx, frame_idx, obj_id,
                  ("mask", (m > 127).astype(np.float32), None))

    def _add(self, state, video_idx, frame_idx, obj_id, payload):
        if state.cond_frame_idx is not None and \
                frame_idx != state.cond_frame_idx:
            raise ValueError(
                "batched groups share ONE prompt frame; got prompts at "
                f"{state.cond_frame_idx} and {frame_idx} — use the "
                "sequential VideoPredictor for multi-frame prompting")
        order = state.obj_order[video_idx]
        if obj_id not in order:
            if len(order) >= self.max_objects:
                raise ValueError(
                    f"more than max_objects={self.max_objects} objects")
            order.append(obj_id)
        state.prompts[video_idx][obj_id] = payload
        state.cond_frame_idx = frame_idx
        state.cond_outputs = None
        state.mem_bank = None

    # -- conditioning -------------------------------------------------------

    def _run_cond_frame(self, state: GroupState):
        """The prompt step of every video's objects at the shared prompt
        frame. Mask and point prompts may mix across videos and objects:
        each kind runs on all rows, and a row takes the mask pass's output
        where it holds a mask prompt, else the point pass's."""
        cfg, dev = self.cfg, self.device
        G, O, S = state.group_size, self.max_objects, cfg.image_size
        f = state.cond_frame_idx
        s0, s1, s16 = (x[:, f] for x in state.feats)
        has_mask = np.zeros((G, O), bool)
        has_pts = np.zeros((G, O), bool)
        maxp = 1
        for g in range(G):
            for i, o in enumerate(state.obj_order[g]):
                kind, pts, _ = state.prompts[g][o]
                if kind == "mask":
                    has_mask[g, i] = True
                else:
                    has_pts[g, i] = True
                    maxp = max(maxp, len(pts))

        results = []
        if has_mask.any():
            masks = np.zeros((G, O, S, S), np.float32)
            for g, i in zip(*np.nonzero(has_mask)):
                masks[g, i] = state.prompts[g][state.obj_order[g][i]][1]
            results.append(self._mask_prompt_step(
                s0, s1, s16, torch.from_numpy(masks).to(dev).reshape(
                    G * O, S, S)))
        if has_pts.any():
            coords = np.zeros((G, O, maxp, 2), np.float32)
            labels = -np.ones((G, O, maxp), np.int32)
            for g, i in zip(*np.nonzero(has_pts)):
                _, pts, lbl = state.prompts[g][state.obj_order[g][i]]
                coords[g, i, : len(pts)] = pts
                labels[g, i, : len(pts)] = lbl
            results.append(self._prompt_step(
                s0, s1, s16,
                torch.from_numpy(coords).to(dev).reshape(G * O, maxp, 2),
                torch.from_numpy(labels).to(dev).reshape(G * O, maxp),
                _use_multimask(cfg, True, maxp)))
        (out, mem, mem_pos), *rest = results
        if self._mem_pos_flat is None:
            self._mem_pos_flat = mem_pos.reshape(-1, cfg.mem_dim)
        lowres, ptr = out["low_res_masks"], out["obj_ptr"]
        if rest:
            (out_p, mem_p, _), = rest
            sel = torch.from_numpy(has_mask.reshape(-1)).to(dev)

            def merge(a, b):
                return torch.where(sel.reshape((-1,) + (1,) * (a.ndim - 1)),
                                   a, b)

            lowres = merge(lowres, out_p["low_res_masks"])
            ptr = merge(ptr, out_p["obj_ptr"])
            mem = merge(mem, mem_p)
        return CondOutput(lowres=lowres, mem=mem, ptr=ptr, score=None)

    # -- propagation --------------------------------------------------------

    def propagate_in_group(self, state: GroupState, reverse: bool = False
                           ) -> Iterator[tuple]:
        """Yields (frame_idx, obj_ids [G lists], logits [G, n_max, 1, S/4,
        S/4] float16 numpy, score [G, n_max] numpy) once per lockstep
        frame, from the prompt frame to the last frame, or to frame 0 with
        ``reverse``. Rows past a video's object count are padding: slice
        video g with len(obj_ids[g]). The conditioning output and the
        memory bank persist on ``state`` across calls, so a forward pass
        after a reverse pass attends to its memories."""
        f = state.cond_frame_idx
        if f is None:
            raise ValueError("no prompts added")
        if state.cond_outputs is None:
            state.cond_outputs = {f: self._run_cond_frame(state)}
            state.mem_bank = {}
        n_max = max(len(o) for o in state.obj_order)
        obj_ids = [list(o) for o in state.obj_order]
        mem_bank = state.mem_bank
        order = ([f] + list(range(f - 1, -1, -1)) if reverse
                 else [f] + list(range(f + 1, state.num_frames)))
        for t in order:
            if t == f:
                packed, score = self._pack(state.cond_outputs[f].lowres,
                                           state.orig_hw, n_max)
            else:
                memory = self._assemble_memory(state, mem_bank,
                                               state.cond_outputs, t, reverse)
                s0, s1, s16 = (x[:, t] for x in state.feats)
                out, mem, packed, score = self._track_step(
                    s0, s1, s16, memory, state.orig_hw, n_max)
                mem_bank[t] = TrackedOutput(mem=mem, ptr=out["obj_ptr"])
            G = state.group_size
            yield (t, obj_ids) + self._fetch(
                packed.reshape((G, n_max) + tuple(packed.shape[1:])),
                score.reshape(G, n_max))
