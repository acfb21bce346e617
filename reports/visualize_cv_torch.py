#!/usr/bin/env python3
"""Render prediction-vs-GT comparison GIFs from eval artifacts
(predict.json + the GT COCO JSON), one GIF per video, with the PyTorch/CUDA
port and without Pillow or imageio (the counterpart of
``visualize_cv.py``, with the same CLI): frames read by
``data/image_io.py`` ``read_rgb`` (PNG or JPEG), masks by the port's RLE
codec, the composites by ``utils/viz.py`` ``overlay_masks`` (ground truth
left, prediction right), the GIFs by ``write_gif`` (its fixed palette).

    python reports/visualize_cv_torch.py --predict <run>/eval/predict.json \
        --coco <val.json> --out-dir <run>/eval/gifs [--max-frames 20]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sam2_video_tpu_torch.data import image_io  # noqa: E402
from sam2_video_tpu_torch.data import rle as rle_mod  # noqa: E402
from sam2_video_tpu_torch.utils import viz  # noqa: E402


def _masks_by_cat(anns, hw, num_categories):
    masks = np.zeros((num_categories, *hw), bool)
    for a in anns:
        c = a["category_id"]
        if 0 <= c < num_categories:
            masks[c] |= rle_mod.decode(a["segmentation"]).astype(bool)
    return masks


def composites(gt: dict, preds: list, max_frames: int) -> dict:
    """video id -> uint8 [T, H, 2W, 3]: each of the first ``max_frames``
    frames (by ``order_in_video``) with the ground truth's masks beside the
    prediction's; a frame whose file is missing is grey 40."""
    num_categories = max(c["id"] for c in gt["categories"]) + 1
    gt_by_img, dt_by_img = {}, {}
    for a in gt["annotations"]:
        gt_by_img.setdefault(a["image_id"], []).append(a)
    for a in preds:
        dt_by_img.setdefault(a["image_id"], []).append(a)
    by_video: dict = {}
    for im in gt["images"]:
        by_video.setdefault(im["video_id"], []).append(im)
    out = {}
    for vid, frames in by_video.items():
        frames.sort(key=lambda f: f.get("order_in_video", 0))
        comps = []
        for im in frames[:max_frames]:
            hw = (im["height"], im["width"])
            path = im.get("path") or im["file_name"]
            if Path(path).exists():
                base = image_io.read_rgb(path)
            else:
                base = np.full((*hw, 3), 40, np.uint8)
            gtm = _masks_by_cat(gt_by_img.get(im["id"], []), hw,
                                num_categories)
            dtm = _masks_by_cat(dt_by_img.get(im["id"], []), hw,
                                num_categories)
            comps.append(np.concatenate([viz.overlay_masks(base, gtm),
                                         viz.overlay_masks(base, dtm)],
                                        axis=1))
        if comps:
            out[vid] = np.stack(comps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--predict", required=True)
    ap.add_argument("--coco", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--max-frames", type=int, default=20)
    ap.add_argument("--fps", type=int, default=3)
    args = ap.parse_args(argv)

    gt = json.loads(Path(args.coco).read_text())
    preds = json.loads(Path(args.predict).read_text())
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for vid, comps in composites(gt, preds, args.max_frames).items():
        viz.write_gif(out_dir / f"{str(vid).strip('_')}.gif", comps,
                  delay_ms=int(1000 / max(args.fps, 1)))
        print(f"{vid}: {len(comps)} frames -> gif")


if __name__ == "__main__":
    main()
