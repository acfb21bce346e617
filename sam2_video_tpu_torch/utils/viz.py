"""Training and eval visualization (counterpart of
``sam2_video_tpu/utils/viz.py``): 2x2 composite frames (image / ground
truth / prompts / prediction) written as a GIF.

The composites are the JAX package's, computed by the same numpy code, bit
for bit. The JAX package writes the GIF through imageio; the card's machine
has neither imageio nor Pillow, so ``write_gif`` writes GIF89a itself: one
fixed palette of 6 x 7 x 6 levels (red, green, blue), each pixel mapped to
its nearest level per channel, so a decoded pixel lies within
``QUANT_STEP`` of the composite in every channel, and LZW-compressed image
data. The frame delay is the JAX package's (1000 / fps ms, in the GIF's
hundredths of a second); like imageio's file it has no loop extension.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# distinct colors per category (RGB, uint8)
_PALETTE = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], np.uint8)

# the GIF's fixed palette: LEVELS[c] levels of channel c, evenly spaced
# over 0..255 and rounded; 252 of the 256 entries are used
LEVELS = (6, 7, 6)
QUANT_STEP = 25     # the largest distance of a channel value from its level


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] ImageNet-normalised float32 -> uint8 RGB. uint8 frames (the
    data pipeline's default, normalised on the device) pass unchanged."""
    if img.dtype == np.uint8:
        return img
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def overlay_masks(img: np.ndarray, masks: np.ndarray,
                  alpha: float = 0.55) -> np.ndarray:
    """img uint8 [H, W, 3]; masks bool [C, H, W] -> blended overlay."""
    out = img.astype(np.float32)
    for c in range(masks.shape[0]):
        m = masks[c] > 0
        if not m.any():
            continue
        color = _PALETTE[c % len(_PALETTE)].astype(np.float32)
        out[m] = (1 - alpha) * out[m] + alpha * color
    return out.astype(np.uint8)


def draw_points(img: np.ndarray, coords: np.ndarray, labels: np.ndarray,
                radius: int = 3) -> np.ndarray:
    """coords [N, 2] (x, y); labels 1 pos (green) / 0 neg (red) / 2,3 box
    corners (blue)."""
    out = img.copy()
    h, w = img.shape[:2]
    colors = {1: (0, 255, 0), 0: (255, 0, 0), 2: (0, 120, 255),
              3: (0, 120, 255)}
    for (x, y), l in zip(np.asarray(coords).reshape(-1, 2),
                         np.asarray(labels).reshape(-1)):
        if l < 0:
            continue
        xi, yi = int(round(x)), int(round(y))
        y0, y1 = max(0, yi - radius), min(h, yi + radius + 1)
        x0, x1 = max(0, xi - radius), min(w, xi + radius + 1)
        out[y0:y1, x0:x1] = colors.get(int(l), (255, 255, 255))
    return out


def composite_frame(image, gt_masks, pred_masks, point_coords=None,
                    point_labels=None) -> np.ndarray:
    """2x2 grid: [image | GT] / [prompts | prediction]; all [H, W, ...]."""
    base = denormalize_image(image)
    gt = overlay_masks(base, gt_masks)
    pred = overlay_masks(base, pred_masks)
    prompts = base
    if point_coords is not None:
        prompts = draw_points(base, point_coords, point_labels)
    top = np.concatenate([base, gt], axis=1)
    bottom = np.concatenate([prompts, pred], axis=1)
    return np.concatenate([top, bottom], axis=0)


def create_visualization_gif(frames, gt_masks, pred_logits, point_coords=None,
                             point_labels=None, max_length: int = 4,
                             stride: int = 1, path=None, fps: int = 2):
    """frames [T, H, W, 3] normalized (or uint8); gt_masks [T, C, H, W]
    bool; pred_logits [T, C, 1, H, W] or [T, C, H, W]; numpy arrays or CPU
    tensors. Returns [T', H', W', 3] uint8 array; writes a GIF when
    ``path`` is given."""
    frames = np.asarray(frames)
    gt_masks = np.asarray(gt_masks)
    pred_logits = np.asarray(pred_logits)
    if pred_logits.ndim == 5:
        pred_logits = pred_logits[:, :, 0]
    idxs = list(range(0, frames.shape[0], stride))[:max_length]
    comps = []
    for t in idxs:
        pc = point_coords if t == 0 else None
        pl = point_labels if t == 0 else None
        comps.append(composite_frame(frames[t], gt_masks[t],
                                     pred_logits[t] > 0, pc, pl))
    out = np.stack(comps)
    if path is not None:
        write_gif(path, out, delay_ms=int(1000 / max(fps, 1)))
    return out


# ---------------------------------------------------------------------------
# GIF89a
# ---------------------------------------------------------------------------


def palette() -> np.ndarray:
    """[256, 3] uint8: the fixed palette, entry (r * 7 + g) * 6 + b for
    levels (r, g, b); the unused tail is black."""
    axes = [np.round(np.arange(n) * (255.0 / (n - 1))).astype(np.uint8)
            for n in LEVELS]
    r, g, b = np.meshgrid(*axes, indexing="ij")
    pal = np.zeros((256, 3), np.uint8)
    pal[:np.prod(LEVELS)] = np.stack([r, g, b], -1).reshape(-1, 3)
    return pal


def quantize(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 -> [...] uint8 palette indices: each channel to its
    nearest level (half-way values to the upper one)."""
    idx = [np.floor(rgb[..., c].astype(np.float64) * (n - 1) / 255.0 + 0.5)
           .astype(np.int64) for c, n in enumerate(LEVELS)]
    return ((idx[0] * LEVELS[1] + idx[1]) * LEVELS[2] + idx[2]).astype(
        np.uint8)


def lzw_codes(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF LZW of a flat uint8 index stream: variable-width codes (9 to 12
    bits), a clear code first and whenever the table is full, packed least
    significant bit first."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    codes, widths = [clear], [min_code_size + 1]
    table: dict[int, int] = {}
    next_code, width = eoi + 1, min_code_size + 1
    data = indices.tobytes()
    prefix = data[0] if data else None
    for byte in data[1:]:
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code == 4096:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = eoi + 1, min_code_size + 1
        else:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        prefix = byte
    if prefix is not None:
        codes.append(prefix)
        widths.append(width)
    codes.append(eoi)
    widths.append(width)
    c = np.asarray(codes, np.int64)
    w = np.asarray(widths, np.int64)
    bits = (c[:, None] >> np.arange(12)) & 1
    bits = bits[np.arange(12)[None, :] < w[:, None]]
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path, frames: np.ndarray, delay_ms: int) -> None:
    """Write [N, H, W, 3] uint8 frames as a GIF89a of the fixed palette,
    each frame shown ``delay_ms`` (rounded to hundredths of a second)."""
    frames = np.asarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    delay = int(round(delay_ms / 10))
    out = bytearray(b"GIF89a")
    # logical screen: a global table of 256 entries, 8 bits per primary
    out += np.asarray([w, h], "<u2").tobytes() + bytes([0xF7, 0, 0])
    out += palette().tobytes()
    for f in frames:
        # graphic control: no disposal, the delay, no transparency
        out += bytes([0x21, 0xF9, 4, 0]) + np.asarray(
            [delay], "<u2").tobytes() + bytes([0, 0])
        out += bytes([0x2C]) + np.asarray([0, 0, w, h], "<u2").tobytes()
        out += bytes([0, 8])
        out += _sub_blocks(lzw_codes(quantize(f).reshape(-1)))
    out.append(0x3B)
    Path(path).write_bytes(bytes(out))
