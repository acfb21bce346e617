"""Saved probability maps -> a COCO ``predict.json`` at a threshold,
without running the model again (counterpart of
``sam2_video_tpu/eval/export_predict_from_probs.py``, reference
export_predict_from_probs.py:22-116): per image and category the
pixelwise max over the category's objects, at or above the threshold,
RLE-encoded, scored by its max. Run from the repository root:

    python3 -m sam2_video_tpu_torch.eval.export_predict_from_probs \\
        --probs-dir <run>/eval/probs --threshold 0.5
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data import rle as rle_mod
from .probs_io import FrameProbs, iter_frame_probs
from .utils import mask_to_bbox


def _frame_detections(frame: FrameProbs, threshold: float,
                      skip_background: bool):
    """Yield one COCO detection per category visible in this frame."""
    for cat in np.unique(frame.categories):
        if skip_background and cat == 0:
            continue
        peak = frame.category_peak(int(cat))
        merged = peak >= threshold
        if not merged.any():
            continue
        yield {
            "image_id": frame.image_id,
            "category_id": int(cat),
            "segmentation": rle_mod.encode(merged.astype(np.uint8)),
            "bbox": mask_to_bbox(merged),
            "iscrowd": 0,
            "score": float(peak.max()),
        }


def export_predict(probs_dir, threshold: float, output_predict=None,
                   exclude_background: bool = False) -> str:
    detections = [det
                  for frame in iter_frame_probs(probs_dir)
                  for det in _frame_detections(frame, threshold,
                                               exclude_background)]
    if output_predict is None:
        output_predict = str(Path(probs_dir).parent /
                             f"predict_t{threshold:.2f}.json")
    Path(output_predict).write_text(json.dumps(detections, indent=2))
    return output_predict


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--probs-dir", required=True)
    ap.add_argument("--threshold", required=True, type=float)
    ap.add_argument("--output-predict", default=None)
    ap.add_argument("--exclude-background", action="store_true")
    args = ap.parse_args()
    out = export_predict(args.probs_dir, args.threshold, args.output_predict,
                         args.exclude_background)
    print(f"wrote predictions to {out}")


if __name__ == "__main__":
    main()
