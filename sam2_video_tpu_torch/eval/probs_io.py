"""Reader of the per-frame probability dumps of ``eval/inference.py``
(``{image_id}.npz`` and ``meta.json``), the counterpart of
``sam2_video_tpu/eval/probs_io.py``: float16 ``probs`` [N, H, W],
``obj_ids`` [N] with ``category = id % mod``, optional ``height`` and
``width`` (reference inference.py:450-485).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class FrameProbs:
    image_id: int
    probs: np.ndarray       # [N, H, W] float32
    categories: np.ndarray  # [N] int, already demodulated
    shape: tuple            # (H, W) of the original frame

    def category_peak(self, cat: int) -> np.ndarray | None:
        """Pixelwise max probability over this category's objects, or None
        if the category has no predicted objects in this frame."""
        rows = self.probs[self.categories == cat]
        return rows.max(axis=0) if rows.shape[0] else None


def load_meta(probs_dir) -> dict:
    meta_path = Path(probs_dir) / "meta.json"
    if not meta_path.exists():
        raise FileNotFoundError(f"meta.json not found in {probs_dir}")
    return json.loads(meta_path.read_text())


def iter_frame_probs(probs_dir):
    """Yield a FrameProbs per dumped frame, in meta-declared order."""
    probs_dir = Path(probs_dir)
    meta = load_meta(probs_dir)
    id_mod = int(meta["mod"])
    frame_ids = meta.get("image_ids") or sorted(
        int(p.stem) for p in probs_dir.glob("*.npz") if p.stem.isdigit())
    for fid in frame_ids:
        entry = probs_dir / f"{fid}.npz"
        if not entry.exists():
            continue
        blob = np.load(entry)
        stack = np.asarray(blob["probs"], np.float32)
        shape = (int(blob["height"]) if "height" in blob else stack.shape[1],
                 int(blob["width"]) if "width" in blob else stack.shape[2])
        yield FrameProbs(int(fid), stack,
                         np.asarray(blob["obj_ids"]) % id_mod, shape)
