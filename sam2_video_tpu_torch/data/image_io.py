"""Frame files without Pillow or OpenCV: a JPEG decoder (libjpeg-turbo's
entropy decoding, Huffman and arithmetic, lossless prediction, IDCT,
upsampling and colour conversion, in C++ with a numpy reference), a PNG
reader and writer (zlib and numpy, the row unfilter in C++) and Pillow's
``resize`` BILINEAR and NEAREST for 8-bit images, reproduced bit for bit
(Pillow's ``libImaging/Resample.c`` and ``Geometry.c``), so the port's
frames and masks equal the JAX pipeline's, which reads them with Pillow
in training and in its tools and with OpenCV in its eval.

``read_rgb`` returns what ``Image.open(path).convert("RGB")`` gives, the
format told by the first bytes (``reader="opencv"``: what ``cv2.imread``
with IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION gives, as RGB). A JPEG:
8-bit samples, Huffman-coded baseline, extended or progressive,
arithmetic-coded sequential or progressive (SOF9, SOF10, with DAC
conditioning), or lossless Huffman (SOF3: predictors 1-7, point
transforms); grey, three components (YCbCr, or RGB by an Adobe transform
0, the ids 'R', 'G', 'B' or, lossless, any ids without a JFIF marker) or
four (CMYK, or YCCK by an Adobe transform other than 0); any sampling
factors that divide the largest, restart intervals; EXIF orientation is
not applied. A PNG of bit depth 16 (grey, grey + alpha, RGB, RGBA), 8 or
1-8 (grey, palette), plain or Adam7-interlaced: alpha is dropped, a
palette is looked up. The two readers' bits differ in three places: a
CMYK / YCCK JPEG (Pillow reads it inverted and converts with
``MULDIV255``, OpenCV with ``k - ((255 - c) k >> 8)``: up to 2 levels
apart, ``cmyk_to_rgb``), a 16-bit grey PNG (Pillow clips each sample to
255, OpenCV takes its high byte, as both do for every other 16-bit colour
type), and a lossless grey JPEG, which OpenCV does not read (the JAX eval
falls back to Pillow, which the port's eval reader returns). Hierarchical
or arithmetic-coded lossless JPEG, 12-bit JPEG, lossless YCbCr or YCCK
(libjpeg converts no colours in lossless mode), a 2-component JPEG, a
truncated or corrupt stream or another format raise ``ValueError`` naming
the file and what it is; Pillow and OpenCV read none of them either.
``read_raw`` gives a PNG's samples as ``np.asarray(Image.open(path))``
does (class-id masks: 16-bit grey as uint16), ``image_size`` a PNG's or
JPEG's size from its header.
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

_helpers: dict = {}


def _helper(name: str, bind, slow: str):
    """The C++ helper ``name`` built and bound (``bind(lib)``), or None with
    a RuntimeWarning, once, that ``slow`` stands in for it."""
    if name not in _helpers:
        lib = host_build.load(name)
        if lib is not None:
            bind(lib)
        else:
            warnings.warn(
                f"the host helper csrc/{name}.cpp could not be built with "
                f"g++: {slow}", RuntimeWarning, stacklevel=3)
        _helpers[name] = lib
    return _helpers[name]


def _bind_unfilter(lib):
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.png_unfilter.restype = i64
    lib.png_unfilter.argtypes = [p_u8, i64, i64, i64, p_u8]


def _bind_jpeg(lib):
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.jpeg_decode.restype = i64
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, p_u8,
                                ctypes.c_char_p, i64]


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
    lib = _helper("png_unfilter", _bind_unfilter,
                  "PNG frames are decoded with the numpy unfilter, whose "
                  "Average and Paeth rows loop in Python and are many times "
                  "slower")
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
    if head.startswith(JPEG_SIGNATURE):
        return "a JPEG file, not a PNG"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "a GIF file"
    if head[:2] == b"BM":
        return "a BMP file"
    return "not a PNG or a JPEG file"


# Adam7: (x0, y0, dx, dy) of the seven passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes, name: str):
    """-> (width, height, depth, colour type, interlace, palette or None,
    the concatenated IDAT bytes), every refusal raised."""
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
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace} is not "
                         "valid")
    if ctype not in COLOUR_TYPES:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    kind_name = COLOUR_TYPES[ctype][0]
    if not (depth == 8 or (depth == 16 and ctype != 3)
            or (depth in (1, 2, 4) and ctype in (0, 3))):
        raise ValueError(f"{name}: {kind_name} PNG of bit depth {depth} is "
                         "not valid")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    return width, height, depth, ctype, interlace, palette, b"".join(idat)


def _png_rows(raw: np.ndarray, width: int, height: int, depth: int,
              channels: int, name: str):
    """Unfilter and unpack one image (or one Adam7 pass) at the start of
    ``raw`` -> (samples [height, width, channels] at their own bit depth,
    uint16 at 16 bits and uint8 below, the bytes used)."""
    bits = depth * channels
    stride = (width * bits + 7) // 8
    used = height * (stride + 1)
    if raw.size < used:
        raise ValueError(f"{name}: PNG image data is too short")
    rows = unfilter(raw[:used], height, stride, max(1, bits // 8))
    if depth == 16:                      # big-endian samples
        return (rows.view(">u2").astype(np.uint16).reshape(
            height, width, channels), used)
    if depth < 8:
        vals = np.unpackbits(rows, axis=1)[:, :width * depth]
        vals = vals.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (vals * weights).sum(-1).astype(np.uint8)[..., None], used
    return rows.reshape(height, width, channels), used


def _png_samples(data: bytes, name: str):
    """PNG bytes -> (samples [H, W, channels] at the file's bit depth,
    uint16 at 16 bits, depth, colour type, palette), Adam7 passes put in
    place."""
    width, height, depth, ctype, interlace, palette, idat = _png_chunks(
        data, name)
    channels = COLOUR_TYPES[ctype][1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if not interlace:
        return (_png_rows(raw, width, height, depth, channels, name)[0],
                depth, ctype, palette)
    px = np.zeros((height, width, channels),
                  np.uint16 if depth == 16 else np.uint8)
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        part, used = _png_rows(raw, pw, ph, depth, channels, name)
        px[y0::dy, x0::dx] = part
        raw = raw[used:]
    return px, depth, ctype, palette


def decode_png(data: bytes, name: str = "<bytes>",
               reader: str = "pillow") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] as ``reader`` gives it: "pillow" for
    ``Image.open(...).convert("RGB")``, "opencv" for ``cv2.imread``'s
    IMREAD_COLOR (BGR turned to RGB). The two differ on 16-bit grey
    alone: Pillow clips each sample to 255, OpenCV takes its high byte, as
    both do for the other 16-bit colour types."""
    px, depth, ctype, palette = _png_samples(data, name)
    if depth == 16:
        if ctype == 0 and reader == "pillow":
            px = np.minimum(px, 255).astype(np.uint8)
        else:
            px = (px >> 8).astype(np.uint8)
        depth = 8
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if ctype == 0:
        grey = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    if ctype == 4:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_raw(path: str | Path) -> np.ndarray:
    """A PNG as ``np.asarray(Image.open(path))`` gives it, no colour
    conversion: grey [H, W] (bool at 1 bit, 2- and 4-bit values scaled to
    0..255 as Pillow's "L;2" / "L;4" unpackers do, uint16 at 16 bits),
    palette indices [H, W], grey + alpha [H, W, 2] (at 16 bits Pillow opens
    it as RGBA: [H, W, 4], the grey repeated), RGB [H, W, 3], RGBA
    [H, W, 4]; 16-bit colour types as their samples' high bytes (class-id
    masks are read this way)."""
    px, depth, ctype, _ = _png_samples(Path(path).read_bytes(), str(path))
    if depth == 16:
        if ctype == 0:
            return px[..., 0]
        px = (px >> 8).astype(np.uint8)
        if ctype == 4:
            px = px[..., [0, 0, 0, 1]]
        return np.ascontiguousarray(px)
    if ctype == 0 and depth == 1:
        return px[..., 0].astype(bool)
    if ctype == 0:
        return px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        return px[..., 0]
    return np.ascontiguousarray(px)


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of a PNG or JPEG from its header alone (PNG IHDR,
    JPEG SOFn), as Pillow's ``Image.open(path).size``."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head.startswith(JPEG_SIGNATURE):
            return jpeg_header(head + f.read(), str(path)).size
    raise ValueError(f"{path}: {_what(head[:8])}")


# ---------------------------------------------------------------------------
# JPEG: libjpeg-turbo's decode as Pillow runs it, bit for bit
# ---------------------------------------------------------------------------

JPEG_SIGNATURE = b"\xff\xd8\xff"
# zigzag position -> natural (row-major) index of the 8x8 block
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
# jidctint.c: CONST_BITS 13, PASS1_BITS 2 and FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
# frame headers that libjpeg-turbo, and so Pillow, does not decode
_SOF_REFUSED = {0xC5: "hierarchical JPEG (SOF5)",
                0xC6: "hierarchical progressive JPEG (SOF6)",
                0xC7: "hierarchical lossless JPEG (SOF7)",
                0xCB: "arithmetic-coded lossless JPEG (SOF11)",
                0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
                0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
                0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)"}
# T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS
# << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed bin
# (probability 0.5) that codes signs and DC refinement bits
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171)


def _idct_1d(x, shift: int):
    """One 8-point pass of ``jpeg_idct_islow`` over arrays x[0..7] (the
    inputs by frequency), descaled by ``shift`` with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` over dequantized blocks [N, 64] in
    natural order: columns, then rows, then + 128 clamped to 0..255. Its
    shortcuts for columns and rows without AC terms give the same numbers
    as the full pass, so every block takes the full pass here. The C
    code's range-limit table (``& RANGE_MASK``) wraps a sum beyond +-512,
    but libjpeg-turbo's SIMD IDCT, which Pillow runs on x86-64 and Arm,
    saturates it: the clamp is Pillow's answer (no encoder's data reaches
    that far; coefficients whose dequantized values overflow 16 bits,
    which the SIMD code wraps, are out of scope). -> uint8 [N, 8, 8]."""
    x = coef.reshape(-1, 8, 8).astype(np.int64)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)],
                           CONST_BITS - PASS1_BITS), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            CONST_BITS + PASS1_BITS + 3), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _clamped_neighbours(a: np.ndarray, axis: int):
    """(previous, next) of every element along ``axis``, the edges
    repeated."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    n = a.shape[axis]
    prev = np.concatenate([first, np.take(a, range(n - 1), axis=axis)], axis)
    nxt = np.concatenate([np.take(a, range(1, n), axis=axis), last], axis)
    return prev, nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * a.shape[axis], *a.shape[axis + 1:])


def upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """jdsample.c, with ``do_fancy_upsampling`` on (Pillow's default) for a
    component of ``plane``'s size sampled h x v times below the largest
    factors: h2v1 and h2v2 triangle filters when the component is wider than
    2 samples, h1v2 always, box replication (``int_upsample``) otherwise.
    Edges repeat the component's first and last samples."""
    a = plane.astype(np.int32)
    if (h, v) == (1, 1):
        return plane
    if (h, v) == (2, 1) and a.shape[1] > 2:
        left, right = _clamped_neighbours(a, 1)
        return _interleave((3 * a + left + 1) >> 2, (3 * a + right + 2) >> 2,
                           1).astype(np.uint8)
    if (h, v) == (1, 2):
        up, down = _clamped_neighbours(a, 0)
        return _interleave((3 * a + up + 1) >> 2, (3 * a + down + 2) >> 2,
                           0).astype(np.uint8)
    if (h, v) == (2, 2) and a.shape[1] > 2:
        up, down = _clamped_neighbours(a, 0)
        rows = []
        for colsum in (3 * a + up, 3 * a + down):
            last, nxt = _clamped_neighbours(colsum, 1)
            rows.append(_interleave((3 * colsum + last + 8) >> 4,
                                    (3 * colsum + nxt + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, v, axis=0), h, axis=1)


def _ycc_tables():
    """jdcolor.c ``build_ycc_rgb_table`` (SCALEBITS 16, ONE_HALF)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda f: int(f * (1 << 16) + 0.5)  # noqa: E731
    return ((fix(1.40200) * x + (1 << 15)) >> 16,
            (fix(1.77200) * x + (1 << 15)) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + (1 << 15))


CR_R, CB_B, CR_G, CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ``ycc_rgb_convert`` of uint8 planes -> uint8 [H, W, 3]."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> 16)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class _JpegFrame:
    """What the markers before a scan say: size, components (id, h, v,
    quantisation table), the coding process, the arithmetic coder's
    conditioning (DAC) and the colour transform's evidence."""

    def __init__(self, name: str):
        self.name = name
        self.progressive = self.arithmetic = self.lossless = False
        self.width = self.height = 0
        self.comps: list[dict] = []
        self.jfif = False
        self.adobe_transform = None
        # DAC values of the 16 conditioning tables, as SOI resets them
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    @property
    def size(self) -> tuple[int, int]:
        return self.width, self.height

    @property
    def hmax(self) -> int:
        return max(c["h"] for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c["v"] for c in self.comps)

    @property
    def unit(self) -> int:
        """Samples across a block: 8 for the DCT, 1 in lossless mode."""
        return 1 if self.lossless else 8

    def read_sof(self, marker: int, body: bytes):
        if self.comps:
            self.fail("JPEG with two frame headers")
        if marker in _SOF_REFUSED:
            self.fail(f"{_SOF_REFUSED[marker]} is not supported (libjpeg, "
                      "and so Pillow, does not decode it)")
        if len(body) < 6:
            self.fail("JPEG frame header is truncated")
        precision, h, w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            self.fail(f"{precision}-bit JPEG is not supported (8-bit only)")
        if n not in (1, 3, 4):
            self.fail(f"{n}-component JPEG is not supported")
        if h == 0 or w == 0:
            self.fail("JPEG of size 0 (or with a DNL marker) is not "
                      "supported")
        if len(body) < 6 + 3 * n:
            self.fail("JPEG frame header is truncated")
        self.progressive = marker in (0xC2, 0xCA)
        self.arithmetic = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        self.width, self.height = w, h
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                self.fail("JPEG component with bad sampling factors or "
                          "table")
            self.comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
        u = self.unit
        for c in self.comps:
            if self.hmax % c["h"] or self.vmax % c["v"]:
                self.fail("JPEG sampling factors that do not divide the "
                          "largest are not supported")
            c["w"] = -(-w * c["h"] // self.hmax)      # downsampled size
            c["hgt"] = -(-h * c["v"] // self.vmax)
            # blocks (samples in lossless mode) across and down, the MCU
            # padding included
            c["bw"] = -(-w // (u * self.hmax)) * c["h"]
            c["bh"] = -(-h // (u * self.vmax)) * c["v"]

    def read_dac(self, body: bytes):
        """jdmarker.c ``get_dac``: (table, value) pairs; tables 0-15 are
        DC (value: U << 4 | L), 16-31 AC (value: K)."""
        if len(body) % 2:
            self.fail("bad JPEG arithmetic conditioning (DAC) segment")
        for i in range(0, len(body), 2):
            t, val = body[i], body[i + 1]
            if t >= 32:
                self.fail("bad JPEG arithmetic conditioning (DAC) segment")
            if t >= 16:
                self.ac_k[t - 16] = val
            elif val & 15 > val >> 4:
                self.fail("bad JPEG arithmetic conditioning (DAC) value")
            else:
                self.dc_l[t], self.dc_u[t] = val & 15, val >> 4

    def colour_space(self) -> str:
        """jdapimin.c ``default_decompress_parms``. 3 components: a JFIF
        marker means YCbCr; else Adobe's transform 0 means RGB (others:
        YCbCr); else component ids 'R', 'G', 'B' mean RGB, and in lossless
        mode so do all others. 4 components: Adobe's transform 0 or no
        Adobe marker means CMYK, other transforms YCCK."""
        n = len(self.comps)
        if n == 1:
            return "grey"
        if n == 4:
            return ("YCCK" if self.adobe_transform not in (None, 0)
                    else "CMYK")
        if self.jfif:
            return "YCbCr"
        if self.adobe_transform is not None:
            return "RGB" if self.adobe_transform == 0 else "YCbCr"
        if self.lossless or [c["id"] for c in self.comps] == [82, 71, 66]:
            return "RGB"
        return "YCbCr"


def _next_segment(data: bytes, pos: int, name: str):
    """The marker at ``pos``, fill bytes skipped -> (marker, body,
    position after the segment); standalone markers have no body."""
    n = len(data)
    if pos >= n:
        raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
    if data[pos] != 0xFF:
        raise ValueError(f"{name}: corrupt JPEG (no marker at byte {pos})")
    while pos < n and data[pos] == 0xFF:
        pos += 1
    if pos >= n:
        raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
    marker = data[pos]
    pos += 1
    if marker in (0x01, 0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos
    if pos + 2 > n:
        raise ValueError(f"{name}: truncated JPEG marker segment")
    length = struct.unpack(">H", data[pos:pos + 2])[0]
    if length < 2 or pos + length > n:
        raise ValueError(f"{name}: truncated JPEG marker segment")
    return marker, data[pos + 2:pos + length], pos + length


def _is_sof(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)


def _read_dqt(body: bytes, tables: dict, frame: _JpegFrame):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or i + 1 + size > len(body):
            frame.fail("bad JPEG quantisation table")
        q = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
        nat = np.zeros(64, np.int64)
        nat[list(ZIGZAG)] = q
        tables[tq] = nat
        i += 1 + size


def _read_dht(body: bytes, tables: dict, frame: _JpegFrame):
    i = 0
    while i < len(body):
        if i + 17 > len(body):
            frame.fail("bad JPEG Huffman table")
        tc, th = body[i] >> 4, body[i] & 15
        counts = list(body[i + 1:i + 17])
        total = sum(counts)
        vals = body[i + 17:i + 17 + total]
        if tc > 1 or th > 3 or len(vals) != total or total > 256:
            frame.fail("bad JPEG Huffman table")
        tables[(tc, th)] = _huffman_lut(counts, vals, frame)
        i += 17 + total


def _huffman_lut(counts, vals, frame: _JpegFrame) -> list:
    """The canonical code of a DHT table as 65536 entries over the next 16
    bits of the stream: length << 8 | symbol, 0 where no code starts."""
    lut = np.zeros(1 << 16, np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                frame.fail("bad JPEG Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _entropy_intervals(data: bytes, pos: int, name: str):
    """The scan's entropy-coded bytes from ``pos``, byte stuffing removed,
    split at restart markers -> (intervals, position of the marker that
    ends the scan)."""
    out, cur, n = [], bytearray(), len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            raise ValueError(f"{name}: truncated JPEG (the scan has no end)")
        cur += data[pos:j]
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            raise ValueError(f"{name}: truncated JPEG (the scan has no end)")
        if data[k] == 0:
            cur.append(0xFF)
            pos = k + 1
        elif 0xD0 <= data[k] <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos = k + 1
        else:
            out.append(bytes(cur))
            return out, k - 1


def _windows(seg: bytes) -> list:
    """The 16 bits from each bit position of ``seg`` (zeros past its end,
    as libjpeg feeds them)."""
    n = 8 * len(seg)
    bits = np.unpackbits(np.frombuffer(seg + bytes(6), np.uint8))
    w = np.zeros(n + 32, np.int64)
    for i in range(16):
        w += bits[i:i + n + 32].astype(np.int64) << (15 - i)
    return w.tolist()


def _int16(v: int) -> int:
    """A coefficient as libjpeg's JCOEF (16 bits) holds it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _JpegScan:
    """One scan decoded in Python into the components' coefficients
    (``jdhuff.c`` sequential, ``jdphuff.c`` progressive)."""

    def __init__(self, frame, coefs, comps, huff, ss, se, ah, al,
                 restart, name):
        self.frame, self.coefs, self.comps = frame, coefs, comps
        self.huff, self.name = huff, name
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.restart = restart

    def corrupt(self, what="corrupt JPEG data"):
        raise ValueError(f"{self.name}: {what}")

    def blocks(self):
        """Each MCU's (component index, block offset) list, in order; in
        lossless mode a block is one sample."""
        f = self.frame
        u = f.unit
        size = u * u
        if len(self.comps) == 1:
            ci = self.comps[0]
            c = f.comps[ci]
            for by in range(-(-c["hgt"] // u)):
                for bx in range(-(-c["w"] // u)):
                    yield [(ci, (by * c["bw"] + bx) * size)]
            return
        mcux = -(-f.width // (u * f.hmax))
        mcuy = -(-f.height // (u * f.vmax))
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for ci in self.comps:
                    c = f.comps[ci]
                    for y in range(c["v"]):
                        for x in range(c["h"]):
                            mcu.append((ci, ((my * c["v"] + y) * c["bw"]
                                             + mx * c["h"] + x) * size))
                yield mcu

    def intervals(self, intervals):
        """(interval bytes, its MCUs) pairs, the restart markers checked
        against the restart interval."""
        mcus = list(self.blocks())
        per = self.restart or len(mcus)
        if len(intervals) != max(1, -(-len(mcus) // per)):
            self.corrupt("corrupt JPEG data (restart markers do not match "
                         "the restart interval)")
        return [(seg, mcus[i * per:(i + 1) * per])
                for i, seg in enumerate(intervals)]

    def run(self, intervals):
        for seg, mcus in self.intervals(intervals):
            self.w, self.p, self.end = _windows(seg), 0, 8 * len(seg)
            self.pred = {ci: 0 for ci in self.comps}
            self.eobrun = 0
            try:
                for mcu in mcus:
                    for ci, off in mcu:
                        self.block(ci, self.coefs[ci], off)
            except IndexError:
                self.corrupt("truncated or corrupt JPEG data")
            if self.p > self.end:
                self.corrupt("truncated or corrupt JPEG data")

    def sym(self, lut) -> int:
        e = lut[self.w[self.p]]
        if not e:
            self.corrupt("corrupt JPEG data (bad Huffman code)")
        self.p += e >> 8
        return e & 255

    def bits(self, s: int) -> int:
        v = self.w[self.p] >> (16 - s)
        self.p += s
        return v

    def value(self, s: int) -> int:
        """``s`` bits as a signed coefficient (HUFF_EXTEND)."""
        if not s:
            return 0
        if s > 16:
            self.corrupt("corrupt JPEG data (coefficient size)")
        v = self.bits(s)
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    def block(self, ci, coef, off):
        f = self.frame
        c = f.comps[ci]
        if not f.progressive:
            self.pred[ci] += self.value(self.sym(self.huff[(0, c["td"])]))
            coef[off] = self.pred[ci]
            ac = self.huff[(1, c["ta"])]
            k = 1
            while k < 64:
                rs = self.sym(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        self.corrupt()
                    coef[off + ZIGZAG[k]] = self.value(s)
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1
        elif self.ss == 0:
            if self.ah == 0:
                self.pred[ci] += self.value(self.sym(self.huff[(0,
                                                               c["td"])]))
                coef[off] = self.pred[ci] << self.al
            elif self.bits(1):
                coef[off] |= 1 << self.al
        elif self.ah == 0:
            self.ac_first(coef, off, self.huff[(1, c["ta"])])
        else:
            self.ac_refine(coef, off, self.huff[(1, c["ta"])])

    def ac_first(self, coef, off, ac):
        if self.eobrun:
            self.eobrun -= 1
            return
        k = self.ss
        while k <= self.se:
            rs = self.sym(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    self.corrupt()
                coef[off + ZIGZAG[k]] = self.value(s) << self.al
            elif r == 15:
                k += 15
            else:
                self.eobrun = (1 << r) + (self.bits(r) if r else 0) - 1
                break
            k += 1

    def ac_refine(self, coef, off, ac):
        p1, m1 = 1 << self.al, -1 << self.al
        k = self.ss
        if not self.eobrun:
            while k <= self.se:
                rs = self.sym(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if self.bits(1) else m1
                elif r != 15:
                    self.eobrun = (1 << r) + (self.bits(r) if r else 0)
                    break
                while k <= self.se:
                    i = off + ZIGZAG[k]
                    if coef[i]:
                        if self.bits(1) and not coef[i] & p1:
                            coef[i] += p1 if coef[i] >= 0 else m1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > 63:
                        self.corrupt()
                    coef[off + ZIGZAG[k]] = s
                k += 1
        if self.eobrun:
            while k <= self.se:
                i = off + ZIGZAG[k]
                if coef[i] and self.bits(1) and not coef[i] & p1:
                    coef[i] += p1 if coef[i] >= 0 else m1
                k += 1
            self.eobrun -= 1


class _LosslessScan(_JpegScan):
    """One lossless Huffman scan (``jdlhuff.c``): each sample's difference
    coded as a DC difference is, category 16 meaning 32768 with no extra
    bits. ``undifference`` then reconstructs the samples."""

    def block(self, ci, coef, off):
        s = self.sym(self.huff[(0, self.frame.comps[ci]["td"])])
        coef[off] = 32768 if s == 16 else self.value(s)

    def mcus_per_row(self) -> int:
        """jddiffct.c: the restart interval must be a whole number of
        these (the predictors restart with a row)."""
        if len(self.comps) == 1:
            return self.frame.comps[self.comps[0]]["w"]
        return -(-self.frame.width // self.frame.hmax)

    def run(self, intervals):
        if self.restart % self.mcus_per_row():
            self.corrupt("lossless JPEG whose restart interval is not a "
                         "whole number of MCU rows")
        super().run(intervals)

    def undifference(self, ci) -> np.ndarray:
        """``jdpred.c`` over the component's differences -> its uint8
        samples [hgt, w]: the first row of the scan and of each restart
        interval predicted from the left (its first sample from 2^(7 -
        Pt)), the first column from above, the rest by the scan's
        predictor (Ss); sums modulo 2^16, shifted left by the point
        transform (Al) and cut to 8 bits as JSAMPLE does."""
        c = self.frame.comps[ci]
        rows = (self.restart // self.mcus_per_row()
                * (1 if len(self.comps) == 1 else c["v"])) or c["hgt"]
        diff = np.asarray(self.coefs[ci], np.int64).reshape(c["bh"], c["bw"])
        out = np.zeros((c["hgt"], c["w"]), np.int64)
        psv = self.ss
        for y in range(c["hgt"]):
            d = diff[y].tolist()
            row = [0] * c["w"]
            if y % rows == 0:
                ra = (d[0] + (1 << (7 - self.al))) & 0xFFFF
                row[0] = ra
                for x in range(1, c["w"]):
                    ra = (d[x] + ra) & 0xFFFF
                    row[x] = ra
            else:
                prev = out[y - 1].tolist()
                rb = prev[0]
                ra = (d[0] + rb) & 0xFFFF
                row[0] = ra
                for x in range(1, c["w"]):
                    rc, rb = rb, prev[x]
                    if psv == 1:
                        p = ra
                    elif psv == 2:
                        p = rb
                    elif psv == 3:
                        p = rc
                    elif psv == 4:
                        p = ra + rb - rc
                    elif psv == 5:
                        p = ra + ((rb - rc) >> 1)
                    elif psv == 6:
                        p = rb + ((ra - rc) >> 1)
                    else:
                        p = (ra + rb) >> 1
                    ra = (d[x] + p) & 0xFFFF
                    row[x] = ra
            out[y] = row
        return ((out << self.al) & 0xFF).astype(np.uint8)


class _ArithDecoder:
    """``jdarith.c`` ``arith_decode`` over one interval's bytes (zeros past
    its end, as libjpeg feeds them after a marker)."""

    def __init__(self, seg: bytes):
        self.seg, self.pos = seg, 0
        self.c, self.a, self.ct = 0, 0, -16     # two bytes read first

    def __call__(self, st, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (self.seg[self.pos]
                                if self.pos < len(self.seg) else 0)
                self.pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                   # conditional LPS exchange
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:                 # conditional MPS exchange
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _ArithScan(_JpegScan):
    """One arithmetic-coded scan (``jdarith.c``: ``decode_mcu`` and the
    four progressive routines). Statistics bins per conditioning table
    (64 DC, 256 AC) and one fixed bin; each restart interval starts them,
    the DC predictions and contexts anew."""

    def run(self, intervals):
        for seg, mcus in self.intervals(intervals):
            self.d = _ArithDecoder(seg)
            self.dc_stats = [bytearray(64) for _ in range(16)]
            self.ac_stats = [bytearray(256) for _ in range(16)]
            self.fixed = bytearray([113])
            self.last_dc = {ci: 0 for ci in self.comps}
            self.dc_ctx = {ci: 0 for ci in self.comps}
            for mcu in mcus:
                for ci, off in mcu:
                    self.block(ci, self.coefs[ci], off)

    def magnitude(self, st, i: int, ac_bins: int = 0) -> int:
        """Figures F.23 and F.24 from bin ``i``: |v| - 1. A DC category
        continues at bin X1 = 20, an AC one past its second decision at
        ``ac_bins`` (X2: 189 or 217)."""
        d = self.d
        m = d(st, i)
        if m and (not ac_bins or d(st, i)):
            if ac_bins:
                m <<= 1
            i = ac_bins or 20
            while d(st, i):
                m <<= 1
                if m == 0x8000:
                    self.corrupt("corrupt JPEG data (arithmetic magnitude "
                                 "overflow)")
                i += 1
        v = m
        i += 14
        while m > 1:
            m >>= 1
            if d(st, i):
                v |= m
        return v

    def dc_diff(self, ci, tbl) -> int:
        """Figure F.19 with the conditioning of F.1.4.4.1.2."""
        st = self.dc_stats[tbl]
        s0 = self.dc_ctx[ci]
        if not self.d(st, s0):
            self.dc_ctx[ci] = 0
            return 0
        sign = self.d(st, s0 + 1)
        v = self.magnitude(st, s0 + 2 + sign)
        m = 1 << (v.bit_length() - 1) if v else 0
        if m < (1 << self.frame.dc_l[tbl]) >> 1:
            self.dc_ctx[ci] = 0
        elif m > (1 << self.frame.dc_u[tbl]) >> 1:
            self.dc_ctx[ci] = 12 + 4 * sign
        else:
            self.dc_ctx[ci] = 4 + 4 * sign
        return -(v + 1) if sign else v + 1

    def ac(self, coef, off, tbl, ss, se, shift):
        """Figure F.20 over ss..se, each value << ``shift``."""
        st, d = self.ac_stats[tbl], self.d
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if d(st, i):
                break                                   # EOB
            while not d(st, i + 1):
                i += 3
                k += 1
                if k > se:
                    self.corrupt("corrupt JPEG data (arithmetic spectral "
                                 "overflow)")
            sign = d(self.fixed, 0)
            v = self.magnitude(st, i + 2,
                                  189 if k <= self.frame.ac_k[tbl] else 217)
            v += 1
            coef[off + ZIGZAG[k]] = _int16((-v if sign else v) << shift)
            k += 1

    def ac_refine(self, coef, off, tbl):
        st, d = self.ac_stats[tbl], self.d
        p1, m1 = 1 << self.al, -1 << self.al
        kex = self.se
        while kex > 0 and not coef[off + ZIGZAG[kex]]:
            kex -= 1
        k = self.ss
        while k <= self.se:
            i = 3 * (k - 1)
            if k > kex and d(st, i):
                break                                   # EOB
            while True:
                j = off + ZIGZAG[k]
                if coef[j]:                             # previously nonzero
                    if d(st, i + 2):
                        coef[j] += m1 if coef[j] < 0 else p1
                    break
                if d(st, i + 1):                        # newly nonzero
                    coef[j] = m1 if d(self.fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > self.se:
                    self.corrupt("corrupt JPEG data (arithmetic spectral "
                                 "overflow)")
            k += 1

    def block(self, ci, coef, off):
        f = self.frame
        c = f.comps[ci]
        if not f.progressive:
            self.last_dc[ci] = (self.last_dc[ci]
                                + self.dc_diff(ci, c["td"])) & 0xFFFF
            coef[off] = _int16(self.last_dc[ci])
            self.ac(coef, off, c["ta"], 1, 63, 0)
        elif self.ss == 0:
            if self.ah == 0:
                self.last_dc[ci] += self.dc_diff(ci, c["td"])
                coef[off] = _int16(self.last_dc[ci] << self.al)
            elif self.d(self.fixed, 0):
                coef[off] |= 1 << self.al
        elif self.ah == 0:
            self.ac(coef, off, c["ta"], self.ss, self.se, self.al)
        else:
            self.ac_refine(coef, off, c["ta"])


def jpeg_header(data: bytes, name: str = "<bytes>") -> _JpegFrame:
    """The frame header of a JPEG (SOFn): size and components, with every
    refusal that the header alone shows."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data[:8])}")
    frame, pos = _JpegFrame(name), 2
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if _is_sof(marker):
            frame.read_sof(marker, body)
            return frame
        if marker in (0xD9, 0xDA):
            frame.fail("JPEG without a frame header (SOF) before its "
                       "first scan")


def jpeg_samples_numpy(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The reference JPEG decoder, the entropy decoding in Python and the
    rest in numpy: libjpeg-turbo's output with its defaults (islow IDCT,
    fancy upsampling; box upsampling in lossless mode), uint8 [H, W, 3]
    (grey repeated, RGB, YCbCr converted) or [H, W, 4] (CMYK as stored,
    YCCK converted to it; Adobe's inversion not undone)."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data[:8])}")
    frame, pos = _JpegFrame(name), 2
    qtables, huff, coefs, latched, samples = {}, {}, {}, {}, {}
    restart, seen_sos = 0, False
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if marker == 0xD9:
            break
        if 0xE0 <= marker <= 0xEF or marker == 0xFE:
            if marker == 0xE0 and body[:5] == b"JFIF\0" and len(body) >= 14:
                frame.jfif = True
            if (marker == 0xEE and body[:5] == b"Adobe"
                    and len(body) >= 12):
                frame.adobe_transform = body[11]
        elif marker == 0xDB:
            _read_dqt(body, qtables, frame)
        elif marker == 0xC4:
            _read_dht(body, huff, frame)
        elif marker == 0xCC:
            frame.read_dac(body)
        elif marker == 0xDD:
            if len(body) < 2:
                frame.fail("bad JPEG restart interval")
            restart = struct.unpack(">H", body[:2])[0]
        elif _is_sof(marker):
            frame.read_sof(marker, body)
            size = frame.unit ** 2
            for ci, c in enumerate(frame.comps):
                coefs[ci] = [0] * (c["bw"] * c["bh"] * size)
        elif marker == 0xDA:
            if not frame.comps:
                frame.fail("JPEG scan before its frame header (SOF)")
            if not seen_sos and frame.lossless and frame.colour_space() in (
                    "YCbCr", "YCCK"):
                frame.fail(f"lossless JPEG in {frame.colour_space()} is not "
                           "supported (libjpeg converts no colours in "
                           "lossless mode, so Pillow cannot read it)")
            seen_sos = True
            scan = _read_sos(body, frame, qtables, huff, latched)
            intervals, pos = _entropy_intervals(data, pos, name)
            kind = (_LosslessScan if frame.lossless else
                    _ArithScan if frame.arithmetic else _JpegScan)
            decoder = kind(frame, coefs, *scan, restart, name)
            decoder.run(intervals)
            if frame.lossless:
                for ci in decoder.comps:
                    samples[ci] = decoder.undifference(ci)
        elif marker == 0xDC and seen_sos:
            pass                                        # DNL after a scan
        else:
            frame.fail(f"JPEG marker 0x{marker:02X} is not supported")
    if not seen_sos:
        frame.fail("JPEG without image data (no scan)")
    planes = []
    for ci, c in enumerate(frame.comps):
        hx, vy = frame.hmax // c["h"], frame.vmax // c["v"]
        if frame.lossless:
            if ci not in samples:
                frame.fail("lossless JPEG without a scan of every component")
            up = np.repeat(np.repeat(samples[ci], vy, 0), hx, 1)
        else:
            q = latched.get(ci)
            blocks = (np.asarray(coefs[ci], np.int64).reshape(-1, 64)
                      * (q if q is not None else 0))
            px = idct_islow(blocks).reshape(c["bh"], c["bw"], 8, 8)
            plane = px.transpose(0, 2, 1, 3).reshape(
                c["bh"] * 8, c["bw"] * 8)[:c["hgt"], :c["w"]]
            up = upsample(plane, hx, vy)
        planes.append(up[:frame.height, :frame.width])
    space = frame.colour_space()
    if space == "grey":
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if space in ("RGB", "CMYK"):
        return np.ascontiguousarray(np.stack(planes, -1))
    rgb = ycc_to_rgb(*planes[:3])
    if space == "YCbCr":
        return rgb
    return np.concatenate([255 - rgb, planes[3][..., None]], -1)  # YCCK


def _read_sos(body, frame, qtables, huff, latched):
    """The scan header: its components (in DCT mode each latching its
    quantisation table at its first scan, as libjpeg does), their tables
    and the spectral selection (in lossless mode: the predictor, 0, 0 and
    the point transform) -> the scan decoder's arguments after
    ``coefs``."""
    if not body or len(body) < 1 + 2 * body[0] + 3:
        frame.fail("JPEG scan header is truncated")
    n = body[0]
    if not 1 <= n <= min(4, len(frame.comps)):       # libjpeg's "Bogus SOS"
        frame.fail(f"JPEG scan header lists {n} components")
    ids = [c["id"] for c in frame.comps]
    comps = []
    for i in range(n):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            frame.fail("JPEG scan of an unknown component")
        ci = ids.index(cid)
        if ci in comps:
            frame.fail("JPEG scan lists a component twice")
        c = frame.comps[ci]
        c["td"], c["ta"] = t >> 4, t & 15
        comps.append(ci)
        if ci not in latched and not frame.lossless:
            if c["tq"] not in qtables:
                frame.fail("JPEG component without a quantisation table")
            latched[ci] = qtables[c["tq"]]
    ss, se, a = body[1 + 2 * n: 4 + 2 * n]
    ah, al = a >> 4, a & 15
    if n > 1 and sum(frame.comps[ci]["h"] * frame.comps[ci]["v"]
                     for ci in comps) > 10:
        frame.fail("JPEG scan with more than 10 blocks per MCU")
    if frame.lossless:
        if not 1 <= ss <= 7 or se or ah or al > 7:
            frame.fail("bad lossless JPEG scan parameters")
    elif frame.progressive:
        if (ss > se or se > 63 or (ss == 0) != (se == 0) or al > 13
                or ah > 13 or (ss and n != 1)):
            frame.fail("bad progressive JPEG scan parameters")
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        frame.fail("bad sequential JPEG scan parameters")
    if not frame.arithmetic:
        for ci in comps:
            c = frame.comps[ci]
            needs = []
            if frame.lossless or (ss == 0 and not (frame.progressive
                                                   and ah)):
                needs.append((0, c["td"]))
            if se:
                needs.append((1, c["ta"]))
            for key in needs:
                if key not in huff:
                    frame.fail("JPEG scan without its Huffman table")
    return comps, huff, ss, se, ah, al


def cmyk_to_rgb(cmyk: np.ndarray, reader: str = "pillow") -> np.ndarray:
    """libjpeg's CMYK output (Adobe's inverted samples) uint8 [H, W, 4] ->
    RGB [H, W, 3] as ``reader`` turns it. "pillow": ``Image.open`` reads
    the samples inverted ("CMYK;I"), then ``convert("RGB")`` computes
    255 - k' - round(c' (255 - k') / 255) with c' = 255 - c (Convert.c
    ``cmyk2rgb``, MULDIV255). "opencv": ``imread`` computes k - ((255 - c)
    k >> 8) on the samples as stored (``icvCvt_CMYK2BGR_8u_C4C3R``)."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    if reader == "opencv":
        return (k - (((255 - x[..., :3]) * k) >> 8)).astype(np.uint8)
    t = (255 - x[..., :3]) * k + 128
    return np.clip(k - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _rgb(samples: np.ndarray, reader: str) -> np.ndarray:
    return cmyk_to_rgb(samples, reader) if samples.shape[-1] == 4 else samples


def decode_jpeg_numpy(data: bytes, name: str = "<bytes>",
                      reader: str = "pillow") -> np.ndarray:
    """``jpeg_samples_numpy`` as RGB: uint8 [H, W, 3] equal to Pillow's
    ``Image.open(...).convert("RGB")``, or to OpenCV's ``imread`` with
    ``reader="opencv"`` (the two differ on 4-component files alone)."""
    return _rgb(jpeg_samples_numpy(data, name), reader)


def decode_jpeg(data: bytes, name: str = "<bytes>",
                reader: str = "pillow") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] as ``decode_jpeg_numpy`` gives them,
    through the C++ helper when it builds (a ``RuntimeWarning``, once,
    when it does not)."""
    frame = jpeg_header(data, name)
    lib = _helper("jpeg_decode", _bind_jpeg,
                  "JPEG frames are decoded with the numpy reference, whose "
                  "entropy decoding loops in Python and is many times "
                  "slower")
    if lib is None:
        return decode_jpeg_numpy(data, name, reader)
    channels = 4 if len(frame.comps) == 4 else 3
    out = np.empty((frame.height, frame.width, channels), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), frame.height, frame.width, channels,
                       out, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return _rgb(out, reader)


def read_rgb(path: str | Path, reader: str = "pillow") -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3]: a JPEG or a PNG, told
    apart by their first bytes, as both readers do (the extension is
    ignored). ``reader`` "pillow" gives ``Image.open(path).convert("RGB")``
    (the training pipeline's reader), "opencv" what the JAX eval's frame
    reader gives: ``cv2.imread(path, IMREAD_COLOR |
    IMREAD_IGNORE_ORIENTATION)`` as RGB, which differs from Pillow on
    CMYK / YCCK JPEG and 16-bit grey PNG; where ``imread`` returns None
    (lossless grey JPEG) that reader falls back to Pillow, which reads it
    as the port does."""
    data = Path(path).read_bytes()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, str(path), reader)
    return decode_png(data, str(path), reader)


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
