"""Threshold grid search over saved probability maps (counterpart of
``sam2_video_tpu/eval/tune_threshold.py``, reference
tune_threshold.py:26-177): thresholds in [t_min, t_max] by t_step; per
image and category the prediction any(prob >= t) against the merged
ground truth; Dice averaged over the (image, category) pairs; the best,
ties to the threshold nearest 0.5; ``best_threshold.json``.

Vectorised over the thresholds: any_i(prob_i >= t) is
max_i(prob_i) >= t, so each pair's Dice curve follows from the counts of
its peak map above each threshold, one sort per pair. Run from the
repository root:

    python3 -m sam2_video_tpu_torch.eval.tune_threshold \\
        --probs-dir <run>/eval/probs --coco-path <annotations.json>
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data import rle as rle_mod
from .probs_io import iter_frame_probs, load_meta  # noqa: F401 (re-export)


def _threshold_axis(lo: float, hi: float, step: float) -> np.ndarray:
    """Inclusive [lo, hi] grid, rounded to kill float-accumulation drift."""
    n = int(np.floor((hi - lo) / step + 1e-9)) + 1
    return np.round(lo + step * np.arange(n), 5)


def _exceedance(samples: np.ndarray, cutoffs: np.ndarray) -> np.ndarray:
    """#{x in samples : x >= c} for every cutoff c, via one sort."""
    ordered = np.sort(samples, axis=None)
    return ordered.size - np.searchsorted(ordered, cutoffs, side="left")


def _pair_dice_curve(peak: np.ndarray | None, gt_mask: np.ndarray,
                     cutoffs: np.ndarray) -> np.ndarray:
    """Dice(threshold) for one (image, category) pair.

    ``peak`` is the pixelwise max probability over the category's objects
    (None when the category has no predicted objects at all).
    """
    gt_area = float(np.count_nonzero(gt_mask))
    if peak is None:
        # Empty prediction at every threshold.
        return np.zeros(cutoffs.shape, np.float64)
    pred_area = _exceedance(peak, cutoffs).astype(np.float64)
    hits = _exceedance(peak[gt_mask], cutoffs).astype(np.float64)
    return 2.0 * hits / (pred_area + gt_area + 1e-7)


def _gt_union(anns: list, shape: tuple) -> np.ndarray:
    out = np.zeros(shape, bool)
    for a in anns:
        out |= rle_mod.decode(a["segmentation"]).astype(bool)
    return out


def grid_search(probs_dir, coco_path, t_min=0.2, t_max=0.8, t_step=0.05,
                exclude_background=False):
    coco = json.loads(Path(coco_path).read_text())
    anns_by_image: dict = {}
    for a in coco["annotations"]:
        anns_by_image.setdefault(a["image_id"], []).append(a)

    cutoffs = _threshold_axis(t_min, t_max, t_step)
    curve_sum = np.zeros(cutoffs.shape, np.float64)
    n_pairs = 0

    for frame in iter_frame_probs(probs_dir):
        frame_anns = anns_by_image.get(frame.image_id, [])
        cat_universe = set(frame.categories.tolist())
        cat_universe |= {a["category_id"] for a in frame_anns}
        if exclude_background:
            cat_universe.discard(0)

        for cat in sorted(cat_universe):
            gt_mask = _gt_union(
                [a for a in frame_anns if a["category_id"] == cat],
                frame.shape)
            peak = frame.category_peak(cat)
            if peak is None and not gt_mask.any():
                continue  # absent on both sides: not a scored pair
            curve_sum += _pair_dice_curve(peak, gt_mask, cutoffs)
            n_pairs += 1

    if n_pairs == 0:
        raise RuntimeError("No valid categories found for Dice computation.")
    curve = curve_sum / n_pairs

    # Best mean Dice; among ties prefer the threshold nearest 0.5.
    order = np.lexsort((np.abs(cutoffs - 0.5), -curve))
    winner = int(order[0])
    per_thr = list(zip(cutoffs.astype(float).tolist(),
                       curve.astype(float).tolist()))
    return float(cutoffs[winner]), float(curve[winner]), per_thr


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--probs-dir", required=True)
    ap.add_argument("--coco-path", required=True)
    ap.add_argument("--min", dest="t_min", type=float, default=0.2)
    ap.add_argument("--max", dest="t_max", type=float, default=0.8)
    ap.add_argument("--step", dest="t_step", type=float, default=0.05)
    ap.add_argument("--exclude-background", action="store_true")
    ap.add_argument("--output-json", default=None)
    args = ap.parse_args()
    best_thr, best_dice, per_thr = grid_search(
        args.probs_dir, args.coco_path, args.t_min, args.t_max, args.t_step,
        args.exclude_background)
    out = args.output_json or str(Path(args.probs_dir).parent /
                                  "best_threshold.json")
    Path(out).write_text(json.dumps({
        "best_threshold": best_thr, "best_dice": best_dice,
        "threshold_curve": per_thr,
        "exclude_background": bool(args.exclude_background),
        "range": {"min": args.t_min, "max": args.t_max, "step": args.t_step},
    }, indent=2))
    print(f"best threshold {best_thr:.3f} (Dice={best_dice:.4f}) -> {out}")


if __name__ == "__main__":
    main()
