"""Synthetic weights, videos and datasets for tests, smoke runs and
profiles, made from a seed: the port's random init moved off its
constants, a smooth background with coloured ellipses drifting across it,
and a COCO-RLE video dataset on disk."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def synthetic_params(cfg, seed: int, only_constant: bool = False):
    """``models/sam2.py`` ``init`` (on the CPU), moved off its constant
    initialisation so that a check of a kernel against its plain version
    sees every stage: each parameter gets + 0.05 N(0, 1) (LayerNorm ones and
    zeros among them); the memory encoder's CXBlock layer scales, 1e-6 at
    init, which would hide both CXBlocks, are drawn from U(0.5, 1.5); and
    the object-score head's last bias is +10, so every object reads present
    and mask logits, not a presence threshold, are compared.

    With ``only_constant`` the noise goes only to the parameters that
    ``init`` sets to one constant (LayerNorm ones and zeros, zero biases and
    embeddings; each gets the same draw as without it), and the randomly
    initialised ones keep the init's scale. On a product with more than
    ~400 inputs the 0.05 noise is wider than the init's own spread, and the
    widest presets' features grow with it."""
    from ..models import sam2 as sam2_mod

    params = sam2_mod.init(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    fuser = params["memory_encoder"]["fuser"]["layers"]
    with torch.no_grad():
        for t in params.parameters():
            noise = torch.randn(t.shape, generator=gen)
            if not only_constant or bool((t == t.flatten()[0]).all()):
                t.add_(noise, alpha=0.05)
        for i in range(cfg.memory_encoder_config.fuser_num_layers):
            gamma = fuser[str(i)]["gamma"]
            gamma.copy_(0.5 + torch.rand(gamma.shape, generator=gen))
        params["sam_mask_decoder"]["pred_obj_score_head"]["layers"]["2"][
            "bias"].fill_(10.0)
    return params


def synthetic_video(seed: int, frames: int, hw=(480, 854), objects: int = 8):
    """uint8 [T, H, W, 3] and the (y, x) centres of the ellipses at t=0."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = (np.stack([xx / W, yy / H, 0.5 + 0.5 * np.sin(xx / 37.0)], -1)
            * 120.0 + 40.0)
    c0 = rng.uniform([60, 80], [H - 60, W - 80], (objects, 2))
    vel = rng.uniform(-6, 6, (objects, 2))
    radii = rng.uniform(25, 55, (objects, 2))
    colours = rng.uniform(0, 255, (objects, 3))
    video = np.empty((frames, H, W, 3), np.uint8)
    for t in range(frames):
        img = base.copy()
        for o in range(objects):
            cy, cx = c0[o] + t * vel[o]
            inside = (((yy - cy) / radii[o, 0]) ** 2
                      + ((xx - cx) / radii[o, 1]) ** 2) <= 1.0
            img[inside] = colours[o]
        video[t] = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    return video, c0


def prompt_all(pred, state, centres, frame_idx: int = 0):
    """One positive point per object at its centre on ``frame_idx``."""
    for o, (cy, cx) in enumerate(centres):
        pred.add_new_points_or_box(state, frame_idx, o, points=[[cx, cy]],
                                   labels=[1])


def example_clip(image_size: int, T: int, O: int, C: int,
                 B: int | None = None, seed: int = 0):
    """The JAX package's example clip (``__graft_entry__.py``
    ``_example_clip``), made with the same numpy calls from ``seed``, so both
    packages get the same arrays: normal images, two square objects in
    categories 0 and 1 (the other objects padding), one positive point each.
    A ``VideoClip``, or a ``VideoClipBatch`` of B copies when B is given."""
    from .types import VideoClip, VideoClipBatch

    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    H = image_size
    images = rng.standard_normal(lead + (T, H, H, 3)).astype(np.float32)
    cat_masks = np.zeros(lead + (T, C, H, H), bool)
    cat_masks[..., 0, H // 8: H // 3, H // 8: H // 3] = True
    cat_masks[..., 1, H // 2: 7 * H // 8, H // 2: 7 * H // 8] = True
    obj_masks = np.zeros(lead + (O, H, H), np.float32)
    obj_masks[..., 0, H // 8: H // 3, H // 8: H // 3] = 1.0
    obj_masks[..., 1, H // 2: 7 * H // 8, H // 2: 7 * H // 8] = 1.0
    obj_to_cat = np.broadcast_to(
        np.asarray([0, 1] + [-1] * (O - 2), np.int32), lead + (O,)).copy()
    coords = np.zeros(lead + (O, 1, 2), np.float32)
    coords[..., 0, 0, :] = (H // 4, H // 4)
    coords[..., 1, 0, :] = (3 * H // 4, 3 * H // 4)
    labels = np.where(obj_to_cat >= 0, 1, -1)[..., None].astype(np.int32)
    cls = VideoClip if B is None else VideoClipBatch
    return cls(images=torch.from_numpy(images),
               cat_masks=torch.from_numpy(cat_masks),
               obj_masks=torch.from_numpy(obj_masks),
               obj_to_cat=torch.from_numpy(obj_to_cat),
               point_coords=torch.from_numpy(coords),
               point_labels=torch.from_numpy(labels))


def make_synthetic_dataset(root: str | Path, num_videos: int = 2,
                           frames_per_video: int = 12, image_hw=(240, 320),
                           num_categories: int = 3, seed: int = 0,
                           png_filters=0) -> Path:
    """A COCO-style video dataset of moving coloured discs, one category
    each, with RLE annotations: ``images/*.png`` and ``annotations.json``
    under ``root``; returns the JSON path. The JAX package's
    ``make_synthetic_dataset`` with the same arguments writes the same JSON
    and the same pixels (its PNG bytes differ: Pillow filters each row
    adaptively, ``png_filters`` sets the filter type here, one for every
    row or one per row)."""
    from . import image_io
    from . import rle as rle_mod

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    h, w = image_hw
    rng = np.random.default_rng(seed)

    images, annotations, ann_id = [], [], 0
    img_id = 0
    for v in range(num_videos):
        centers = rng.uniform(40, min(h, w) - 40, (num_categories, 2))
        vels = rng.uniform(-4, 4, (num_categories, 2))
        radii = rng.uniform(14, 30, num_categories)
        for f in range(frames_per_video):
            frame = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            for c in range(num_categories):
                cy, cx = centers[c] + vels[c] * f
                cy = float(np.clip(cy, 5, h - 5))
                cx = float(np.clip(cx, 5, w - 5))
                mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < radii[c] ** 2
                color = np.zeros(3, np.uint8)
                color[c % 3] = 200
                frame[mask] = color
                if mask.any():
                    seg = rle_mod.encode(mask.astype(np.uint8))
                    annotations.append({
                        "id": ann_id, "image_id": img_id, "category_id": c,
                        "segmentation": seg, "area": int(mask.sum()),
                        "bbox": rle_mod.to_bbox(seg), "iscrowd": 0,
                    })
                    ann_id += 1
            fname = f"vid{v}_frame{f:03d}.png"
            image_io.write_png(root / "images" / fname, frame, png_filters)
            images.append({
                "file_name": fname, "path": str(root / "images" / fname),
                "height": h, "width": w, "id": img_id,
                "video_id": f"vid{v}", "is_det_keyframe": True,
                "order_in_video": f,
            })
            img_id += 1

    categories = [{"id": c, "name": f"cat{c}"} for c in range(num_categories)]
    out = {"images": images, "annotations": annotations,
           "categories": categories}
    json_path = root / "annotations.json"
    json_path.write_text(json.dumps(out))
    return json_path
