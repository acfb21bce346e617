"""COCO-style video datasets: the index of images, annotations and videos,
and per-frame loading (counterpart of ``sam2_video_tpu/data/coco.py``).

``COCOIndex`` keeps the keyframe filter, the category id -> contiguous
index map (an empty ``categories`` list raises), and the videos' frames
sorted by ``order_in_video``; ``clip_windows`` cuts each video into
fixed-length windows with a stride. A frame (PNG or JPEG) is read,
resized so that its smaller edge is ``image_size`` (Pillow's BILINEAR) and
center-cropped; a mask is RLE-decoded, resized with Pillow's NEAREST,
cropped and OR-merged per category. ``image_io`` does both without Pillow,
with the same bits.
"""

from __future__ import annotations

import collections
import json
import threading
from pathlib import Path
from typing import Any

import numpy as np

from . import image_io
from . import rle as rle_mod

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resize_smaller_edge(w: int, h: int, size: int) -> tuple[int, int]:
    """torchvision Resize(int): the smaller edge becomes ``size``."""
    if h <= w:
        return int(round(w * size / h)), size
    return size, int(round(h * size / w))


def center_crop_box(w: int, h: int, size: int) -> tuple[int, int]:
    """(left, top) of the centered size x size crop."""
    return (w - size) // 2, (h - size) // 2


class COCOIndex:
    """A parsed COCO JSON with its video and clip structure."""

    def __init__(self, json_path: str | Path, image_size: int,
                 num_categories: int | None = None,
                 filter_keyframes: bool = True,
                 frame_cache_mb: float = 0.0):
        self.json_path = Path(json_path)
        if not self.json_path.exists():
            raise FileNotFoundError(f"COCO JSON not found: {self.json_path}")
        data = json.loads(self.json_path.read_text())
        self.image_size = image_size

        self.images: list[dict] = data.get("images", [])
        if filter_keyframes:
            self.images = [im for im in self.images
                           if im.get("is_det_keyframe", True)]
        self.annotations: list[dict] = data.get("annotations", [])
        self.categories: list[dict] = data.get("categories", [])
        if not self.categories:
            raise ValueError("COCO JSON must include a non-empty "
                             "'categories' list")
        sorted_cats = sorted(self.categories, key=lambda c: c.get("id", 0))
        self.catid_to_idx = {c["id"]: i for i, c in enumerate(sorted_cats)}
        self.num_categories = (num_categories if num_categories is not None
                               else len(sorted_cats))

        self.image_id_to_annotations: dict[Any, list[dict]] = {}
        for ann in self.annotations:
            self.image_id_to_annotations.setdefault(
                ann["image_id"], []).append(ann)

        self.video_to_images: dict[Any, list[dict]] = {}
        for im in self.images:
            self.video_to_images.setdefault(im.get("video_id", 0), []).append(im)
        for vid in self.video_to_images:
            self.video_to_images[vid].sort(
                key=lambda x: x.get("order_in_video", 0))

        self.image_id_to_idx = {im["id"]: i for i, im in enumerate(self.images)}
        self._mask_cache: dict[Any, np.ndarray] = {}
        # decoded frames (after resize and crop, S*S*3 bytes each), least
        # recently used dropped first within frame_cache_mb; a lock, as the
        # loader reads from a thread pool
        self._frame_cache_budget = int(frame_cache_mb * 1024 * 1024)
        self._frame_cache: collections.OrderedDict[tuple, np.ndarray] = \
            collections.OrderedDict()
        self._frame_cache_lock = threading.Lock()

    def load_image(self, idx: int, image_root: str | None = None,
                   normalize: bool = True) -> np.ndarray:
        """-> [S, S, 3] float32 ImageNet-normalised, or the uint8 frame with
        ``normalize=False`` (``forward_image`` then normalises on the
        device)."""
        raw = self._decoded_frame(idx, image_root)
        if not normalize:
            return raw
        arr = raw.astype(np.float32) / 255.0
        return (arr - IMAGENET_MEAN) / IMAGENET_STD

    def _decoded_frame(self, idx: int, image_root: str | None) -> np.ndarray:
        """[S, S, 3] uint8 frame after resize and crop, cached within the
        ``frame_cache_mb`` budget. A cached frame is read-only (a consumer
        writing into a hit would change every later epoch); the key holds
        ``image_root``, so one index used with two roots keeps them
        apart."""
        key = (idx, image_root)
        if self._frame_cache_budget:
            with self._frame_cache_lock:
                hit = self._frame_cache.get(key)
                if hit is not None:
                    self._frame_cache.move_to_end(key)
                    return hit
        info = self.images[idx]
        path = info.get("path") or info["file_name"]
        if image_root is not None:
            cand = Path(image_root) / info.get("file_name", Path(path).name)
            if cand.exists():
                path = str(cand)
        img = image_io.read_rgb(path)
        s = self.image_size
        nw, nh = resize_smaller_edge(img.shape[1], img.shape[0], s)
        img = image_io.resize_bilinear(img, (nw, nh))
        left, top = center_crop_box(nw, nh, s)
        raw = np.ascontiguousarray(
            image_io.crop(img, (left, top, left + s, top + s)))
        if self._frame_cache_budget:
            raw.setflags(write=False)
            entry = raw.nbytes
            with self._frame_cache_lock:
                self._frame_cache[key] = raw
                while (len(self._frame_cache) * entry
                       > self._frame_cache_budget):
                    self._frame_cache.popitem(last=False)
        return raw

    def load_masks(self, image_id) -> np.ndarray:
        """-> [num_categories, S, S] bool (resized, center-cropped and
        OR-merged per category; cached)."""
        if image_id in self._mask_cache:
            return self._mask_cache[image_id]
        s = self.image_size
        masks = np.zeros((self.num_categories, s, s), bool)
        for ann in self.image_id_to_annotations.get(image_id, []):
            seg = ann.get("segmentation")
            cat_id = ann.get("category_id")
            if seg is None or cat_id is None:
                continue
            cat_idx = self.catid_to_idx.get(cat_id)
            if cat_idx is None or cat_idx >= self.num_categories:
                continue
            m = rle_mod.decode(seg)
            h, w = m.shape
            nw, nh = resize_smaller_edge(w, h, s)
            mi = image_io.resize_nearest(m, (nw, nh))
            left, top = center_crop_box(nw, nh, s)
            masks[cat_idx] |= image_io.crop(
                mi, (left, top, left + s, top + s)) > 0
        self._mask_cache[image_id] = masks
        return masks

    def mask_empty(self, image_id) -> bool:
        return not self.load_masks(image_id).any()


def clip_windows(index: COCOIndex, clip_length: int, stride: int):
    """Fixed-length clip windows per video: dicts of video_id, clip_start
    and image indices."""
    clips = []
    for video_id, images in index.video_to_images.items():
        start = 0
        while start + clip_length <= len(images):
            idxs = [index.image_id_to_idx[images[start + i]["id"]]
                    for i in range(clip_length)]
            clips.append({"video_id": video_id, "clip_start": start,
                          "image_indices": idxs})
            start += stride
    return clips
