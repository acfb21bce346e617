"""Clip assembly and the prefetching input pipeline on the host
(counterpart of ``sam2_video_tpu/data/pipeline.py``): thread-pool
prefetch, a batch size of one or more, a shuffle per epoch from
``(seed, epoch)``, a shard per process (``process_index`` /
``process_count``), and the prompts made here, so the model sees tensors
of static shapes. Batches are ``VideoClipBatch``es of CPU tensors; the
train step moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..utils import prompts as prompts_mod
from . import coco as coco_mod
from .types import FIELDS, VideoClipBatch


@dataclasses.dataclass
class ClipDatasetConfig:
    clip_length: int = 10
    stride: int = 10
    prompt_type: str = "point"
    max_objects: int = 8
    num_pos_points: int = 1
    num_neg_points: int = 0
    include_center: bool = True
    image_root: str | None = None
    # uint8 frames, normalised on the device by forward_image
    uint8_images: bool = True


class ClipDataset:
    """Indexable clip dataset of numpy samples with static shapes."""

    def __init__(self, index: coco_mod.COCOIndex, cfg: ClipDatasetConfig):
        self.index = index
        self.cfg = cfg
        self.clips = coco_mod.clip_windows(index, cfg.clip_length, cfg.stride)

    def __len__(self):
        return len(self.clips)

    def _resolve_frame(self, img_idx: int) -> int:
        """A frame whose masks are empty is replaced by the next image."""
        n = len(self.index.images)
        for _ in range(n):
            image_id = self.index.images[img_idx]["id"]
            if not self.index.mask_empty(image_id):
                return img_idx
            img_idx = (img_idx + 1) % n
        raise ValueError("all images have empty masks")

    def get(self, i: int, rng: np.random.Generator) -> dict:
        cfg = self.cfg
        clip = self.clips[i]
        frame_idxs = [self._resolve_frame(j) for j in clip["image_indices"]]
        images = np.stack([
            self.index.load_image(j, cfg.image_root,
                                  normalize=not cfg.uint8_images)
            for j in frame_idxs])
        cat_masks = np.stack([
            self.index.load_masks(self.index.images[j]["id"])
            for j in frame_idxs])                    # [T, C, H, W]

        obj_masks, obj_to_cat = prompts_mod.cat_to_obj_masks(
            cat_masks[0], cfg.max_objects)
        if cfg.prompt_type == "box":
            coords, labels = prompts_mod.generate_box_prompt(obj_masks)
        else:
            coords, labels = prompts_mod.generate_point_prompt(
                obj_masks, cfg.num_pos_points, cfg.num_neg_points,
                cfg.include_center, rng)
        return {
            "images": images if cfg.uint8_images
            else images.astype(np.float32),
            "cat_masks": cat_masks,
            "obj_masks": obj_masks,
            "obj_to_cat": obj_to_cat,
            "point_coords": coords,
            "point_labels": labels,
        }


class ClipLoader:
    """Shuffled, prefetching, optionally sharded batch iterator."""

    def __init__(self, dataset: ClipDataset, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 2, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(idx)
        return idx[self.process_index::self.process_count]

    def __iter__(self) -> Iterator[VideoClipBatch]:
        idx = self._epoch_indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        base_seed = (self.seed, self.epoch, self.process_index)

        def load_batch(bi: int):
            samples = []
            for j, di in enumerate(batches[bi]):
                rng = np.random.default_rng(base_seed + (bi, j))
                samples.append(self.dataset.get(int(di), rng))
            return VideoClipBatch(**{
                k: torch.from_numpy(np.stack([s[k] for s in samples]))
                for k in FIELDS})

        self.epoch += 1
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = queue.Queue()
            depth = min(self.prefetch + 1, len(batches))
            for i in range(depth):
                pending.put(pool.submit(load_batch, i))
            nxt = depth
            for _ in range(len(batches)):
                fut = pending.get()
                if nxt < len(batches):
                    pending.put(pool.submit(load_batch, nxt))
                    nxt += 1
                yield fut.result()
