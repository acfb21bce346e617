"""Conditioning-frame selection (the same rule as
``sam2_video_tpu/eval/utils.py``)."""

from __future__ import annotations


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
