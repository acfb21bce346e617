"""Prompt-noise ablations (counterpart of ``sam2_video_tpu/eval/noise.py``):
perturb mask and box prompts before inference with a shift, scale and
rotation of masks, a random dilation or erosion, or a shifted and scaled
box. ``random.Random(seed)`` is drawn in the JAX class's order, so the
same seed gives the same noise.

The JAX class warps masks with ``cv2.getRotationMatrix2D`` and
``cv2.warpAffine(INTER_NEAREST)`` and dilates or erodes them with
``MORPH_RECT`` kernels; ``warp_affine_nearest`` and
``eval/utils.py morph_square`` compute the same on numpy, bit for bit.
OpenCV (5.x, 8-bit single-channel) maps each destination pixel in
float32 arithmetic: the inverse of the matrix in double, cast to float;
per row the base y M1 + M2; over blocks of ``WARP_LANES`` columns
fma(M0, x, base), and for the columns after the last whole block
fma(x, M0, y M1) + M2; each coordinate rounded half to even, and a pixel
that maps outside the source reads 0 (BORDER_CONSTANT).
"""

from __future__ import annotations

import math
import random

import numpy as np

from .utils import PromptObj, morph_square

# columns per vector block of OpenCV's warpAffine on the host it was
# matched on (AVX2: two 8-lane float registers)
WARP_LANES = 16


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D, [2, 3] float64."""
    a = angle * math.pi / 180.0
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform in double, flattened."""
    m = np.asarray(m, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5],
                     a21, a22, -a21 * m[2] - a22 * m[5]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the float32 product is exact in
    float64."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine_nearest(src: np.ndarray, m: np.ndarray,
                        dsize: tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine(src, m, dsize, flags=INTER_NEAREST) of a 2-D uint8
    array; ``dsize`` is (width, height)."""
    w, h = dsize
    mi = _invert_affine(m).astype(np.float32)
    x = np.arange(w, dtype=np.float32)[None]
    y = np.arange(h, dtype=np.float32)[:, None]
    mapped = []
    for r in (0, 3):
        c0, c1, c2 = mi[r], mi[r + 1], mi[r + 2]
        coord = _fma32(c0, x, y * c1 + c2)
        tail = (w // WARP_LANES) * WARP_LANES
        coord[:, tail:] = _fma32(c0, x[:, tail:], y * c1) + c2
        mapped.append(np.rint(coord).astype(np.int64))
    sx, sy = mapped
    H, W = src.shape
    inside = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.zeros((h, w), src.dtype)
    out[inside] = src[sy[inside], sx[inside]]
    return out


class PromptObjNoiseAdder:
    def __init__(self, bbox_noise_type: str = "shift_scale",
                 noise_intensity: float = 0.1, seed: int | None = None):
        if bbox_noise_type not in ("shift", "scale", "shift_scale"):
            raise ValueError(
                "Invalid bbox_noise_type. Choose from 'shift', 'scale', or "
                "'shift_scale'.")
        self.bbox_noise_type = bbox_noise_type
        self.noise_intensity = noise_intensity
        self.rng = random.Random(seed)

    # -- mask ---------------------------------------------------------------

    def _shift_scale_rotate_mask(self, mask: np.ndarray) -> np.ndarray:
        h, w = mask.shape
        ni = self.noise_intensity
        dx = self.rng.uniform(-ni, ni) * w
        dy = self.rng.uniform(-ni, ni) * h
        scale = 1.0 + self.rng.uniform(-ni, ni)
        angle = self.rng.uniform(-45 * ni, 45 * ni)
        m = rotation_matrix((w / 2, h / 2), angle, scale)
        m[:, 2] += (dx, dy)
        return warp_affine_nearest(mask.astype(np.uint8), m, (w, h))

    def _dilate_or_erode(self, mask: np.ndarray) -> np.ndarray:
        k = self.rng.randrange(3, 3 + int(21 * self.noise_intensity), 2)
        erode = self.rng.random() >= 0.5
        return morph_square(mask, k, k // 2, erode).astype(np.uint8)

    def add_noise_to_mask(self, obj: PromptObj):
        mask = obj.mask.astype(np.uint8)
        if self.rng.random() < 0.5:
            mask = self._shift_scale_rotate_mask(mask)
        if self.rng.random() < 0.5:
            mask = self._dilate_or_erode(mask)
        obj.mask = mask.astype(bool)
        if obj.mask.sum() == 0:
            return None
        return obj

    # -- bbox ---------------------------------------------------------------

    def add_noise_to_bbox(self, obj: PromptObj):
        if self.rng.random() >= 0.5:
            return obj  # p=0.5 identity like the reference transform
        x0, y0, x1, y1 = obj.bbox
        h, w = obj.mask.shape
        ni = self.noise_intensity
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        bw, bh = x1 - x0, y1 - y0
        if self.bbox_noise_type in ("shift", "shift_scale"):
            cx += self.rng.uniform(-ni, ni) * w
            cy += self.rng.uniform(-ni, ni) * h
        if self.bbox_noise_type in ("scale", "shift_scale"):
            s = 1.0 + self.rng.uniform(-ni, ni)
            bw *= s
            bh *= s
        nx0 = max(0.0, cx - bw / 2)
        ny0 = max(0.0, cy - bh / 2)
        nx1 = min(float(w - 1), cx + bw / 2)
        ny1 = min(float(h - 1), cy + bh / 2)
        if nx1 <= nx0 or ny1 <= ny0:
            return None
        obj.bbox = [nx0, ny0, nx1, ny1]
        return obj

    def add_noise_to_obj(self, obj: PromptObj, prompt_type: str):
        if prompt_type == "mask":
            return self.add_noise_to_mask(obj)
        if prompt_type == "bbox":
            return self.add_noise_to_bbox(obj)
        return obj
