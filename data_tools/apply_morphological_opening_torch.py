#!/usr/bin/env python3
"""Apply a kxk morphological opening to every annotation mask in a COCO JSON,
dropping annotations whose mask becomes empty, with the PyTorch/CUDA port
and without OpenCV (the counterpart of ``apply_morphological_opening.py``,
with the same CLI and the same output): the opening is
``cv2.morphologyEx(m, MORPH_OPEN, ones(k, k))`` computed bit for bit with
scipy (``utils/prompts.py`` ``open_square``), the RLEs with the port's
codec (``data/rle.py``).

    python data_tools/apply_morphological_opening_torch.py <in.json>
        <out.json> [--kernel-size 5]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sam2_video_tpu_torch.data import rle as rle_mod  # noqa: E402
from sam2_video_tpu_torch.utils.prompts import open_square  # noqa: E402


def apply_opening(coco_data: dict, kernel_size: int = 5) -> dict:
    keep = []
    dropped = 0
    for ann in coco_data["annotations"]:
        seg = ann.get("segmentation")
        if seg is None:
            keep.append(ann)
            continue
        opened = open_square(rle_mod.decode(seg), kernel_size)
        if opened.sum() == 0:
            dropped += 1
            continue
        ann["segmentation"] = rle_mod.encode(opened)
        ann["area"] = int(opened.sum())
        keep.append(ann)
    coco_data["annotations"] = keep
    print(f"kept {len(keep)} annotations, dropped {dropped} emptied ones")
    return coco_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input_json")
    ap.add_argument("output_json")
    ap.add_argument("--kernel-size", type=int, default=5)
    args = ap.parse_args(argv)
    data = json.loads(Path(args.input_json).read_text())
    data = apply_opening(data, args.kernel_size)
    Path(args.output_json).write_text(json.dumps(data))
    print(f"wrote {args.output_json}")


if __name__ == "__main__":
    main()
