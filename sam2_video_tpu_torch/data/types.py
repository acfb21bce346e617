"""Clip batches as dataclasses of tensors (counterpart of
``sam2_video_tpu/data/types.py``): the same fields, shapes and meaning. The
object axis is padded to ``num_objects``; padding has ``obj_to_cat = -1``.
"""

from __future__ import annotations

import dataclasses

import torch

FIELDS = ("images", "cat_masks", "obj_masks", "obj_to_cat", "point_coords",
          "point_labels")


@dataclasses.dataclass
class VideoClip:
    """One clip (no batch axis).

    images:       [T, H, W, 3] float32, ImageNet-normalised (or uint8)
    cat_masks:    [T, C, H, W] bool, per-category ground truth
    obj_masks:    [O, H, W] float32, frame-0 objects (prompt source)
    obj_to_cat:   [O] int, category per object, -1 for padding
    point_coords: [O, P, 2] float32, (x, y) pixel coordinates
    point_labels: [O, P] int, 1 positive / 0 negative / 2, 3 box / -1 pad
    """
    images: torch.Tensor
    cat_masks: torch.Tensor
    obj_masks: torch.Tensor
    obj_to_cat: torch.Tensor
    point_coords: torch.Tensor
    point_labels: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]

    @property
    def num_objects(self) -> int:
        return self.obj_masks.shape[0]

    @property
    def obj_valid(self) -> torch.Tensor:
        return self.obj_to_cat >= 0


@dataclasses.dataclass
class VideoClipBatch:
    """A batch of clips: every field gains a leading [B] axis."""
    images: torch.Tensor
    cat_masks: torch.Tensor
    obj_masks: torch.Tensor
    obj_to_cat: torch.Tensor
    point_coords: torch.Tensor
    point_labels: torch.Tensor

    def clip(self, i: int) -> VideoClip:
        return VideoClip(**{f: getattr(self, f)[i] for f in FIELDS})

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    def to(self, device) -> "VideoClipBatch":
        return VideoClipBatch(**{f: getattr(self, f).to(device)
                                 for f in FIELDS})
