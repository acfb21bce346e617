"""COCO RLE codec: decode, encode, area, bbox, merge and IoU (counterpart of
``sam2_video_tpu/data/rle.py``). numpy, with the C++ codec of
``native/rle.cpp`` for the string decode, the run fill and the mask to
counts step when it builds (``rle_native``, on first use).
``NATIVE_AVAILABLE`` says which codec is in use (None until the first
call decides); both give the same results.

Format (COCO mask spec): runs in column-major order, alternating
background and foreground, background first; the compressed string packs
the counts 5 bits per character (offset 48), least significant first, 0x20
continues, sign-extended, and counts[i] for i > 2 is stored as the
difference to counts[i - 2].
"""

from __future__ import annotations

import numpy as np

from . import rle_native
from .rle_native import (counts_from_mask_native, decode_counts_native,
                         encode_counts_native, fill_native)

NATIVE_AVAILABLE: bool | None = None


def _native() -> bool:
    global NATIVE_AVAILABLE
    if NATIVE_AVAILABLE is None:
        NATIVE_AVAILABLE = rle_native.load() is not None
    return NATIVE_AVAILABLE


def decode_counts(s: str) -> np.ndarray:
    """Compressed RLE string -> int64 counts."""
    if _native():
        return decode_counts_native(s)
    data = np.frombuffer(s.encode("ascii"), dtype=np.uint8).astype(np.int64) - 48
    counts = []
    i, n = 0, len(data)
    while i < n:
        x = 0
        k = 0
        while True:
            c = data[i]
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return np.asarray(counts, dtype=np.int64)


def encode_counts(counts: np.ndarray) -> str:
    """int counts -> compressed RLE string."""
    if _native():
        return encode_counts_native(np.asarray(counts, np.int64))
    out = []
    counts = np.asarray(counts, dtype=np.int64)
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _counts_list(rle: dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, str):
        return decode_counts(c)
    if isinstance(c, bytes):
        return decode_counts(c.decode("ascii"))
    return np.asarray(c, dtype=np.int64)


def decode(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str | list} -> uint8 [h, w] mask."""
    h, w = rle["size"]
    counts = _counts_list(rle)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")
    if _native():
        flat = fill_native(counts, total)
    else:
        ends = np.cumsum(counts)
        starts = ends - counts
        flat = np.zeros(h * w, dtype=np.uint8)
        for s, e in zip(starts[1::2], ends[1::2]):
            flat[s:e] = 1
    return flat.reshape((w, h)).T


def encode(mask: np.ndarray) -> dict:
    """uint8 / bool [h, w] mask -> compressed RLE dict (as pycocotools)."""
    h, w = mask.shape
    flat = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8).T.reshape(-1))
    if _native() and flat.size:
        counts = counts_from_mask_native(flat)
    else:
        diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        bounds = np.concatenate([[0], diffs, [flat.size]])
        counts = np.diff(bounds)
        if flat.size and flat[0] == 1:
            counts = np.concatenate([[0], counts])
        if flat.size == 0:
            counts = np.asarray([0], dtype=np.int64)
    return {"size": [int(h), int(w)], "counts": encode_counts(counts)}


def area(rle: dict) -> int:
    return int(_counts_list(rle)[1::2].sum())


def to_bbox(rle: dict) -> list[float]:
    """[x, y, w, h], as pycocotools' toBbox."""
    ys, xs = np.nonzero(decode(rle))
    if xs.size == 0:
        return [0.0, 0.0, 0.0, 0.0]
    return [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]


def merge_or(rles: list[dict]) -> np.ndarray:
    """The union of a list of RLEs as a bool mask."""
    if not rles:
        raise ValueError("merge_or needs at least one RLE")
    out = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        out |= decode(r).astype(bool)
    return out


def iou(rle_a: dict, rle_b: dict) -> float:
    a = decode(rle_a).astype(bool)
    b = decode(rle_b).astype(bool)
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum()) / float(union) if union else 0.0
