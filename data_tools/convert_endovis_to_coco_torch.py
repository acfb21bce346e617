#!/usr/bin/env python3
"""Convert an EndoVis-style dataset (per-frame PNG class masks + labels.json)
to the extended COCO format the training pipeline consumes
(images[*].video_id / order_in_video / is_det_keyframe, RLE segmentations),
with the PyTorch/CUDA port and without Pillow (the counterpart of
``convert_endovis_to_coco.py``, with the same CLI and the same output):
frame sizes from the image headers (``data/image_io.py`` ``image_size``),
class-id masks as their raw grey values (16-bit masks as uint16, so ids
above 255 match) or palette indices (``read_raw``, what
``np.asarray(Image.open(...))`` gives), RLEs from the port's codec
(``data/rle.py``). Conversion runs in a thread pool.

Expected source layout:
    <source>/labels.json                 [{"name": ..., "classid"|"color": ...}]
    <source>/images/seq_X_frameNNN.png
    <source>/annotations/seq_X_frameNNN.png   (class-id masks)

    python data_tools/convert_endovis_to_coco_torch.py <source> <out.json>
        [--n-jobs 8]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from sam2_video_tpu_torch.data import image_io  # noqa: E402
from sam2_video_tpu_torch.data import rle as rle_mod  # noqa: E402


def extract_sequence_and_frame(filename: str):
    """'seq_10_frame000.png' -> ('seq_10_', 0)."""
    m = re.match(r"(.+?)frame(\d+)\.png$", filename)
    if not m:
        raise ValueError(f"unrecognized frame filename: {filename}")
    return m.group(1), int(m.group(2))


def bbox_from_mask(mask: np.ndarray):
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return [0.0, 0.0, 0.0, 0.0]
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [float(cmin), float(rmin), float(cmax - cmin + 1),
            float(rmax - rmin + 1)]


def convert(source_dir: str, output_path: str, n_jobs: int = 8):
    source = Path(source_dir)
    labels = json.loads((source / "labels.json").read_text())
    categories = [{"id": i, "name": l["name"]} for i, l in enumerate(labels)]
    classid_to_cat = {l.get("classid", i): i for i, l in enumerate(labels)}

    image_files = sorted((source / "images").glob("*.png"))
    ann_dir = source / "annotations"

    def process(args):
        image_id, path = args
        w, h = image_io.image_size(path)
        seq, frame = extract_sequence_and_frame(path.name)
        info = {"file_name": path.name, "path": str(path), "height": h,
                "width": w, "id": image_id, "video_id": seq,
                "is_det_keyframe": True, "order_in_video": frame}
        anns = []
        mask_path = ann_dir / path.name
        if mask_path.exists():
            label_mask = image_io.read_raw(mask_path)
            if label_mask.ndim == 3:
                label_mask = label_mask[..., 0]
            for classid, cat in classid_to_cat.items():
                m = (label_mask == classid).astype(np.uint8)
                if classid == 0 or m.sum() == 0:
                    continue
                seg = rle_mod.encode(m)
                anns.append({"image_id": image_id, "category_id": cat,
                             "segmentation": seg, "area": int(m.sum()),
                             "bbox": bbox_from_mask(m), "iscrowd": 0})
        return info, anns

    with ThreadPoolExecutor(max_workers=max(n_jobs, 1)) as pool:
        results = list(pool.map(process, enumerate(image_files)))

    images, annotations = [], []
    ann_id = 0
    for info, anns in results:
        if not anns:
            info["is_det_keyframe"] = False
        images.append(info)
        for a in anns:
            a["id"] = ann_id
            ann_id += 1
            annotations.append(a)

    out = {"images": images, "annotations": annotations,
           "categories": categories}
    Path(output_path).write_text(json.dumps(out))
    print(f"wrote {len(images)} images / {len(annotations)} annotations "
          f"-> {output_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source_dir")
    ap.add_argument("output_path")
    ap.add_argument("--n-jobs", type=int, default=8)
    args = ap.parse_args(argv)
    convert(args.source_dir, args.output_path, args.n_jobs)


if __name__ == "__main__":
    main()
