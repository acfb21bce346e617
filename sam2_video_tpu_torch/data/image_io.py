"""Frame files without Pillow: a PNG reader and writer (zlib and numpy, the
row unfilter in C++) and Pillow's ``resize`` BILINEAR and NEAREST for 8-bit
images, reproduced bit for bit (Pillow's ``libImaging/Resample.c`` and
``Geometry.c``), so the port's frames and masks equal the JAX pipeline's,
which reads them with Pillow.

``read_rgb`` returns what ``Image.open(path).convert("RGB")`` gives for a
non-interlaced PNG of bit depth 8 (grey, grey + alpha, RGB, RGBA) or 1-8
(grey, palette): alpha is dropped, a palette is looked up. An interlaced or
16-bit PNG, or a file that is not a PNG (a JPEG among them), raises
``ValueError`` naming the file and what it is.
"""

from __future__ import annotations

import ctypes
import math
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np

from . import host_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, channels)
COLOUR_TYPES = {0: ("grey", 1), 2: ("RGB", 3), 3: ("palette", 1),
                4: ("grey+alpha", 2), 6: ("RGBA", 4)}
PRECISION_BITS = 22          # Resample.c's fixed point for 8-bit images

_unfilter_lib = None


def _native_unfilter():
    global _unfilter_lib
    if _unfilter_lib is None:
        lib = host_build.load("png_unfilter")
        if lib is not None:
            p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.png_unfilter.restype = i64
            lib.png_unfilter.argtypes = [p_u8, i64, i64, i64, p_u8]
        else:
            warnings.warn(
                "the PNG unfilter helper (csrc/png_unfilter.cpp) could not "
                "be built with g++: PNG frames are decoded with the numpy "
                "unfilter, whose Average and Paeth rows loop in Python and "
                "are many times slower", RuntimeWarning, stacklevel=3)
        _unfilter_lib = lib or False
    return _unfilter_lib or None


def unfilter_numpy(data: np.ndarray, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Reference unfilter: ``data`` holds ``height`` rows of a filter byte
    and ``stride`` filtered bytes; returns [height, stride] uint8."""
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, src = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            row = src.copy()
        elif f == 1:
            pad = (-stride) % bpp
            r = np.concatenate([src, np.zeros(pad, np.uint8)])
            row = np.cumsum(r.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif f == 2:
            row = src + prev
        elif f in (3, 4):
            row = np.zeros(stride, np.uint8)
            b_all = prev.astype(np.int32)
            for x0 in range(0, stride, bpp):
                sl = slice(x0, min(x0 + bpp, stride))
                n = sl.stop - sl.start
                a = (row[x0 - bpp:x0 - bpp + n].astype(np.int32) if x0
                     else np.zeros(n, np.int32))
                b = b_all[sl]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = (b_all[x0 - bpp:x0 - bpp + n] if x0
                         else np.zeros(n, np.int32))
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                row[sl] = (src[sl].astype(np.int32) + pred).astype(np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = row
        prev = row
    return out


def unfilter(data: np.ndarray, height: int, stride: int,
             bpp: int) -> np.ndarray:
    """``unfilter_numpy`` through the C++ helper when it builds (a
    ``RuntimeWarning``, once, when it does not)."""
    lib = _native_unfilter()
    if lib is None:
        return unfilter_numpy(data, height, stride, bpp)
    data = np.ascontiguousarray(data, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    out = np.empty((height, stride), np.uint8)
    bad = lib.png_unfilter(data, height, stride, bpp, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out


def _what(head: bytes) -> str:
    if head.startswith(b"\xff\xd8\xff"):
        return ("a JPEG file (not supported: PNG frames only; JPEG is "
                "ROADMAP.md, queue 1, item 5's open gap)")
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "a GIF file"
    if head[:2] == b"BM":
        return "a BMP file"
    return "not a PNG file"


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3], as Pillow's ``convert("RGB")``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data[:8])}")
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{name}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or image data")
    width, height, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{name}: interlaced PNG (Adam7) is not supported")
    if ctype not in COLOUR_TYPES:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    kind_name, channels = COLOUR_TYPES[ctype]
    if depth == 16:
        raise ValueError(f"{name}: 16-bit {kind_name} PNG is not supported")
    if depth != 8 and (ctype not in (0, 3) or depth not in (1, 2, 4)):
        raise ValueError(f"{name}: {kind_name} PNG of bit depth {depth} is "
                         "not valid")
    bits = depth * channels
    stride = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: PNG image data is too short")
    rows = unfilter(raw[:height * (stride + 1)], height, stride,
                    max(1, bits // 8))
    if depth < 8:
        vals = np.unpackbits(rows, axis=1)[:, :width * depth]
        vals = vals.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (vals * weights).sum(-1).astype(np.uint8)
    else:
        px = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        idx = px if depth < 8 else px[..., 0]
        return table[idx]
    if ctype == 0:
        grey = px if depth < 8 else px[..., 0]
        grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    if ctype == 4:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_rgb(path: str | Path) -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3] (PNG only)."""
    return decode_png(Path(path).read_bytes(), str(path))


def _filter_rows(rows: np.ndarray, filters: np.ndarray, bpp: int):
    """Forward PNG filtering of [H, stride] uint8 rows, type per row."""
    H, stride = rows.shape
    r = rows.astype(np.int32)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(r), a, b, (a + b) >> 1, paeth])
    pred = preds[filters, np.arange(H)]
    out = np.empty((H, stride + 1), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = ((r - pred) & 0xFF).astype(np.uint8)
    return out


def encode_png(img: np.ndarray, filters=0) -> bytes:
    """uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG
    bytes. ``filters`` is one filter type (0-4) for every row or one per
    row."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    f = np.broadcast_to(np.asarray(filters, np.int64), (H,))
    if ((f < 0) | (f > 4)).any():
        raise ValueError("PNG filter types are 0-4")
    body = _filter_rows(img.reshape(H, W * ch), f, ch)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray, filters=0) -> None:
    Path(path).write_bytes(encode_png(img, filters))


# ---------------------------------------------------------------------------
# Pillow's resize, bit for bit
# ---------------------------------------------------------------------------


def _bilinear_coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` (support 1, the triangle filter)
    and ``normalize_coeffs_8bpc``: -> (first source index [out], fixed-point
    weights [out, ksize] with zeros past each window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.trunc(center - support + 0.5).astype(np.int64)
    xmin = np.maximum(xmin, 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        t = np.abs((x + xmin - center + 0.5) * ss)
        w = np.where(t < 1.0, 1.0 - t, 0.0)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww += w                     # in Resample.c's order
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + k * (1 << PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _bilinear_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of uint8 ``img`` along ``axis`` (1: x, 0: y), tap
    by tap in int32 (255 times the weights' sum stays below 2^31)."""
    in_size = img.shape[axis]
    xmin, k = _bilinear_coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    out_shape = list(img.shape)
    out_shape[axis] = out_size
    acc = np.full(out_shape, 1 << (PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        w = k[:, j].astype(np.int32)
        if not w.any():
            continue
        idx = np.minimum(xmin + j, in_size - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int32) * w.reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow ``img.resize((w, h), Image.BILINEAR)`` of uint8 [H, W(, C)]:
    the horizontal pass first, clamped to uint8, then the vertical one."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _bilinear_pass(out, w, 1)
    if h != img.shape[0]:
        out = _bilinear_pass(out, h, 0)
    return out if out is not img else img.copy()


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c ``ImagingScaleAffine``: the source coordinate starts at
    a[0] / 2 and advances by repeated float64 addition of a[0] = in / out,
    then is truncated."""
    step = float(in_size) / out_size
    o = 0.0 + step * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        idx[x] = -1 if o < 0.0 else int(o)
        o += step
    if idx.min() < 0 or idx.max() >= in_size:
        raise ValueError("nearest resize index outside the source")
    return idx


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow ``img.resize((w, h), Image.NEAREST)`` of [H, W(, C)]."""
    w, h = size
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(
        img.shape[1], w)]


def crop(img: np.ndarray, box: tuple[int, int, int, int]) -> np.ndarray:
    """Pillow ``img.crop((left, top, right, bottom))`` inside the image."""
    left, top, right, bottom = box
    if left < 0 or top < 0 or right > img.shape[1] or bottom > img.shape[0]:
        raise ValueError(f"crop box {box} outside the image {img.shape[:2]}")
    return img[top:bottom, left:right]
