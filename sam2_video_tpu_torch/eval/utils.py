"""Eval-side prompt datatypes and mask utilities (counterpart of
``sam2_video_tpu/eval/utils.py``): ``ClipRange`` / ``PromptObj`` /
``PromptInfo``, the optional point grid, ``mask_to_masks``,
``mask_to_points``, ``mask_to_bbox`` and the conditioning-frame selection.

The JAX package splits a ground-truth mask into objects with OpenCV: a
closing by a 10 x 10 square (``morphologyEx(MORPH_CLOSE)``), then
``connectedComponents``. ``mask_to_masks`` computes the same on numpy and
scipy, bit for bit:

- OpenCV anchors the even kernel at (5, 5): dilation and erosion both take
  the neighbours at offsets -5..4 of each pixel, on each axis;
- its default morphology border leaves the border neutral: outside the
  image counts as 0 for the dilation and as 1 for the erosion;
- components are numbered as OpenCV numbers them
  (``utils/prompts.py label_components``: by their first 2 x 2 block).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..utils.prompts import label_components

# the point grid of ``init_grid``; module-level, as in the JAX package, so
# that the runner sets it once for every later ``mask_to_points`` call
_GRID = None

CLOSE_SIZE, CLOSE_ANCHOR = 10, 5


@dataclasses.dataclass
class ClipRange:
    start_idx: int
    end_idx: int


@dataclasses.dataclass
class PromptObj:
    mask: np.ndarray
    bbox: list
    points: np.ndarray
    obj_id: int
    pos_or_neg_label: np.ndarray


@dataclasses.dataclass
class PromptInfo:
    prompt_objs: List[PromptObj]
    frame_idx: int
    prompt_type: str
    video_id: str
    path: str
    clip_range: Optional[ClipRange]


def init_grid(image_hw, spacing: int):
    """Constrain point sampling to every ``spacing``-th pixel."""
    global _GRID
    h, w = image_hw
    g = np.zeros((h, w), bool)
    g[::spacing, ::spacing] = True
    _GRID = g


def _rank_filter(m: np.ndarray, size: int, anchor: int, axis: int,
                 erode: bool) -> np.ndarray:
    """OR (dilation) or AND (erosion) of m[i + j - anchor], j < size, along
    ``axis``; outside the image 0 for the dilation, 1 for the erosion."""
    n = m.shape[axis]
    pad = [(0, 0)] * m.ndim
    pad[axis] = (anchor, size - 1 - anchor)
    padded = np.pad(m, pad, constant_values=erode)
    out = None
    for j in range(size):
        v = np.take(padded, np.arange(j, j + n), axis=axis)
        out = v if out is None else (out & v if erode else out | v)
    return out


def morph_square(mask: np.ndarray, size: int, anchor: int,
                 erode: bool) -> np.ndarray:
    """cv2.erode / cv2.dilate of a binary mask by a size x size square
    anchored at (anchor, anchor), with OpenCV's default border, as bool;
    by rows, then by columns (the square is separable)."""
    m = np.asarray(mask) > 0
    for axis in (0, 1):
        m = _rank_filter(m, size, anchor, axis, erode)
    return m


def close_square(mask: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(mask, MORPH_CLOSE, ones((10, 10))): the dilation,
    then the erosion."""
    dilated = morph_square(mask, CLOSE_SIZE, CLOSE_ANCHOR, False)
    return morph_square(dilated, CLOSE_SIZE, CLOSE_ANCHOR, True)


def mask_to_masks(mask: np.ndarray, min_area: int = 10) -> list[np.ndarray]:
    """Split a binary mask into the connected components of its closing;
    drop those under ``min_area`` pixels. uint8 masks."""
    labels, n = label_components(close_square(mask))
    out = []
    for i in range(1, n + 1):
        comp = labels == i
        if comp.sum() >= min_area:
            out.append(comp.astype(np.uint8))
    return out


def mask_to_points(mask: np.ndarray, num_points: int = 1,
                   include_center: bool = True,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Sample (x, y) points inside a mask: the centre of mass first if
    asked, then random pixels (on the grid, if one is set and the mask
    meets it)."""
    rng = rng or np.random.default_rng()
    m = np.asarray(mask) > 0
    if _GRID is not None:
        mg = m & _GRID
        if mg.any():
            m = mg
    ys, xs = np.nonzero(m)
    if xs.size == 0 or num_points <= 0:
        return np.zeros((0, 2), np.float32)
    pts = []
    if include_center:
        pts.append((float(xs.mean()), float(ys.mean())))
    need = num_points - len(pts)
    if need > 0:
        idx = rng.permutation(xs.size)[:need]
        pts.extend(zip(xs[idx].astype(float), ys[idx].astype(float)))
    while len(pts) < num_points:
        pts.append(pts[0])
    return np.asarray(pts, np.float32)


def mask_to_bbox(mask: np.ndarray) -> list[float]:
    """[x_min, y_min, x_max, y_max] of a mask; zeros when it is empty."""
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    if xs.size == 0:
        return [0.0, 0.0, 0.0, 0.0]
    return [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]


def select_closest_cond_frames(frame_idx: int, cond_frame_outputs: dict,
                               max_cond_frame_num: int):
    """Pick up to ``max_cond_frame_num`` conditioning frames temporally
    closest to ``frame_idx``: nearest before, nearest at/after, then by
    absolute distance (sam2_utils.py:19-61). Returns (selected, unselected)."""
    if max_cond_frame_num == -1 or \
            len(cond_frame_outputs) <= max_cond_frame_num:
        return dict(cond_frame_outputs), {}
    if max_cond_frame_num < 2:
        raise ValueError("limiting needs max_cond_frame_num >= 2")
    selected = {}
    before = max((t for t in cond_frame_outputs if t < frame_idx),
                 default=None)
    if before is not None:
        selected[before] = cond_frame_outputs[before]
    after = min((t for t in cond_frame_outputs if t >= frame_idx),
                default=None)
    if after is not None:
        selected[after] = cond_frame_outputs[after]
    remaining = sorted((t for t in cond_frame_outputs if t not in selected),
                       key=lambda x: abs(x - frame_idx))
    for t in remaining[: max_cond_frame_num - len(selected)]:
        selected[t] = cond_frame_outputs[t]
    unselected = {t: v for t, v in cond_frame_outputs.items()
                  if t not in selected}
    return selected, unselected
