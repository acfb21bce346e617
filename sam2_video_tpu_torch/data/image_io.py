"""Frame files without Pillow: a JPEG decoder (the Huffman decoding, IDCT,
upsampling and colour conversion of libjpeg-turbo as Pillow runs it, in
C++ with a numpy reference), a PNG reader and writer (zlib and numpy, the
row unfilter in C++) and Pillow's ``resize`` BILINEAR and NEAREST for 8-bit
images, reproduced bit for bit (Pillow's ``libImaging/Resample.c`` and
``Geometry.c``), so the port's frames and masks equal the JAX pipeline's,
which reads them with Pillow (and OpenCV in its eval).

``read_rgb`` returns what ``Image.open(path).convert("RGB")`` gives, the
format told by the first bytes: for a JPEG, baseline, extended or
progressive Huffman with 8-bit samples, grey or three components, any
sampling factors that divide the largest, restart intervals (EXIF
orientation is not applied, as Pillow's open does not); for a PNG of bit
depth 8 (grey, grey + alpha, RGB, RGBA) or 1-8 (grey, palette), plain or
Adam7-interlaced: alpha is dropped, a palette is looked up. Arithmetic-
coded, lossless, hierarchical or 12-bit JPEG, CMYK / YCCK, a truncated or
corrupt stream, a 16-bit PNG or another format raise ``ValueError`` naming
the file and what it is. ``read_raw`` gives a PNG's samples as
``np.asarray(Image.open(path))`` does (class-id masks), ``image_size`` a
PNG's or JPEG's size from its header.
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
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, p_u8,
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
    if depth == 16:
        raise ValueError(f"{name}: 16-bit {kind_name} PNG is not supported")
    if depth != 8 and (ctype not in (0, 3) or depth not in (1, 2, 4)):
        raise ValueError(f"{name}: {kind_name} PNG of bit depth {depth} is "
                         "not valid")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    return width, height, depth, ctype, interlace, palette, b"".join(idat)


def _png_rows(raw: np.ndarray, width: int, height: int, depth: int,
              channels: int, name: str):
    """Unfilter and unpack one image (or one Adam7 pass) at the start of
    ``raw`` -> (samples uint8 [height, width, channels] at their own bit
    depth, the bytes used)."""
    bits = depth * channels
    stride = (width * bits + 7) // 8
    used = height * (stride + 1)
    if raw.size < used:
        raise ValueError(f"{name}: PNG image data is too short")
    rows = unfilter(raw[:used], height, stride, max(1, bits // 8))
    if depth < 8:
        vals = np.unpackbits(rows, axis=1)[:, :width * depth]
        vals = vals.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (vals * weights).sum(-1).astype(np.uint8)[..., None], used
    return rows.reshape(height, width, channels), used


def _png_samples(data: bytes, name: str):
    """PNG bytes -> (samples uint8 [H, W, channels] at the file's bit
    depth, depth, colour type, palette), Adam7 passes put in place."""
    width, height, depth, ctype, interlace, palette, idat = _png_chunks(
        data, name)
    channels = COLOUR_TYPES[ctype][1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if not interlace:
        return (_png_rows(raw, width, height, depth, channels, name)[0],
                depth, ctype, palette)
    px = np.zeros((height, width, channels), np.uint8)
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        part, used = _png_rows(raw, pw, ph, depth, channels, name)
        px[y0::dy, x0::dx] = part
        raw = raw[used:]
    return px, depth, ctype, palette


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3], as Pillow's ``convert("RGB")``."""
    px, depth, ctype, palette = _png_samples(data, name)
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
    """A PNG of bit depth 8 or less as ``np.asarray(Image.open(path))``
    gives it, no colour conversion: grey [H, W] (bool at 1 bit, 2- and
    4-bit values scaled to 0..255 as Pillow's "L;2" / "L;4" unpackers do),
    palette indices [H, W], grey + alpha [H, W, 2], RGB [H, W, 3], RGBA
    [H, W, 4] (class-id masks are read this way)."""
    px, depth, ctype, _ = _png_samples(Path(path).read_bytes(), str(path))
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
_SOF_REFUSED = {0xC3: "lossless JPEG (SOF3)",
                0xC5: "hierarchical JPEG (SOF5)",
                0xC6: "hierarchical JPEG (SOF6)",
                0xC7: "hierarchical lossless JPEG (SOF7)",
                0xC9: "arithmetic-coded JPEG (SOF9)",
                0xCA: "arithmetic-coded progressive JPEG (SOF10)",
                0xCB: "arithmetic-coded lossless JPEG (SOF11)",
                0xCC: "arithmetic-coded JPEG (DAC marker)",
                0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
                0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
                0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)"}


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
    """What the markers before the first scan say: size, components
    (id, h, v, quantisation table), the colour transform's evidence."""

    def __init__(self, name: str):
        self.name = name
        self.progressive = False
        self.width = self.height = 0
        self.comps: list[dict] = []
        self.jfif = False
        self.adobe_transform = None

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

    def read_sof(self, marker: int, body: bytes):
        if self.comps:
            self.fail("JPEG with two frame headers")
        if marker in _SOF_REFUSED:
            self.fail(f"{_SOF_REFUSED[marker]} is not supported")
        if len(body) < 6:
            self.fail("JPEG frame header is truncated")
        precision, h, w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            self.fail(f"{precision}-bit JPEG is not supported (8-bit only)")
        if n == 4:
            self.fail("4-component (CMYK/YCCK) JPEG is not supported")
        if n not in (1, 3):
            self.fail(f"{n}-component JPEG is not supported")
        if h == 0 or w == 0:
            self.fail("JPEG of size 0 (or with a DNL marker) is not "
                      "supported")
        if len(body) < 6 + 3 * n:
            self.fail("JPEG frame header is truncated")
        self.progressive = marker == 0xC2
        self.width, self.height = w, h
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                self.fail("JPEG component with bad sampling factors or "
                          "table")
            self.comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
        for c in self.comps:
            if self.hmax % c["h"] or self.vmax % c["v"]:
                self.fail("JPEG sampling factors that do not divide the "
                          "largest are not supported")
            c["w"] = -(-w * c["h"] // self.hmax)      # downsampled size
            c["hgt"] = -(-h * c["v"] // self.vmax)

    def is_rgb(self) -> bool:
        """jdapimin.c ``default_decompress_parms`` for 3 components: a JFIF
        marker means YCbCr; else Adobe's transform 0 means RGB (1 or other:
        YCbCr); else component ids 'R', 'G', 'B' mean RGB."""
        if self.jfif:
            return False
        if self.adobe_transform is not None:
            return self.adobe_transform == 0
        return [c["id"] for c in self.comps] == [82, 71, 66]


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
        """Each MCU's (component index, block offset) list, in order."""
        f = self.frame
        if len(self.comps) == 1:
            ci = self.comps[0]
            c = f.comps[ci]
            bw = -(-c["w"] // 8)
            stride = self.coefs[ci][1]
            for by in range(-(-c["hgt"] // 8)):
                for bx in range(bw):
                    yield [(ci, (by * stride + bx) * 64)]
            return
        mcux = -(-f.width // (8 * f.hmax))
        mcuy = -(-f.height // (8 * f.vmax))
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for ci in self.comps:
                    c = f.comps[ci]
                    stride = self.coefs[ci][1]
                    for y in range(c["v"]):
                        for x in range(c["h"]):
                            mcu.append((ci, ((my * c["v"] + y) * stride
                                             + mx * c["h"] + x) * 64))
                yield mcu

    def run(self, intervals):
        mcus = list(self.blocks())
        per = self.restart or len(mcus)
        if len(intervals) != max(1, -(-len(mcus) // per)):
            self.corrupt("corrupt JPEG data (restart markers do not match "
                         "the restart interval)")
        for i, seg in enumerate(intervals):
            self.w, self.p, self.end = _windows(seg), 0, 8 * len(seg)
            self.pred = {ci: 0 for ci in self.comps}
            self.eobrun = 0
            try:
                for mcu in mcus[i * per:(i + 1) * per]:
                    for ci, off in mcu:
                        self.block(ci, self.coefs[ci][0], off)
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


def jpeg_header(data: bytes, name: str = "<bytes>") -> _JpegFrame:
    """The frame header of a JPEG (SOFn): size and components, with every
    refusal that the header alone shows."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data[:8])}")
    frame, pos = _JpegFrame(name), 2
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if _is_sof(marker) or marker == 0xCC:
            frame.read_sof(marker, body)
            return frame
        if marker in (0xD9, 0xDA):
            frame.fail("JPEG without a frame header (SOF) before its "
                       "first scan")


def decode_jpeg_numpy(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The reference JPEG decoder, Huffman in Python and the rest in numpy:
    uint8 [H, W, 3] equal to Pillow's ``Image.open(...).convert("RGB")``
    (libjpeg-turbo with its defaults: islow IDCT, fancy upsampling)."""
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data[:8])}")
    frame, pos = _JpegFrame(name), 2
    qtables, huff, coefs, latched = {}, {}, {}, {}
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
        elif marker == 0xDD:
            if len(body) < 2:
                frame.fail("bad JPEG restart interval")
            restart = struct.unpack(">H", body[:2])[0]
        elif _is_sof(marker) or marker == 0xCC:
            frame.read_sof(marker, body)
            for ci, c in enumerate(frame.comps):
                bw = -(-frame.width // (8 * frame.hmax)) * c["h"]
                bh = -(-frame.height // (8 * frame.vmax)) * c["v"]
                coefs[ci] = ([0] * (bw * bh * 64), bw, bh)
        elif marker == 0xDA:
            if not frame.comps:
                frame.fail("JPEG scan before its frame header (SOF)")
            seen_sos = True
            scan = _read_sos(body, frame, qtables, huff, latched)
            intervals, pos = _entropy_intervals(data, pos, name)
            _JpegScan(frame, coefs, *scan, restart, name).run(intervals)
        elif marker == 0xDC and seen_sos:
            pass                                        # DNL after a scan
        else:
            frame.fail(f"JPEG marker 0x{marker:02X} is not supported")
    if not seen_sos:
        frame.fail("JPEG without image data (no scan)")
    planes = []
    for ci, c in enumerate(frame.comps):
        flat, bw, bh = coefs[ci]
        q = latched.get(ci)
        blocks = (np.asarray(flat, np.int64).reshape(-1, 64)
                  * (q if q is not None else 0))
        px = idct_islow(blocks).reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
        plane = px.reshape(bh * 8, bw * 8)[:c["hgt"], :c["w"]]
        up = upsample(plane, frame.hmax // c["h"], frame.vmax // c["v"])
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if frame.is_rgb():
        return np.ascontiguousarray(np.stack(planes, -1))
    return ycc_to_rgb(*planes)


def _read_sos(body, frame, qtables, huff, latched):
    """The scan header: its components (each latching its quantisation
    table at its first scan, as libjpeg does), their tables and the
    spectral selection -> the _JpegScan arguments after ``coefs``."""
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
        if ci not in latched:
            if c["tq"] not in qtables:
                frame.fail("JPEG component without a quantisation table")
            latched[ci] = qtables[c["tq"]]
    ss, se, a = body[1 + 2 * n: 4 + 2 * n]
    ah, al = a >> 4, a & 15
    if n > 1 and sum(frame.comps[ci]["h"] * frame.comps[ci]["v"]
                     for ci in comps) > 10:
        frame.fail("JPEG scan with more than 10 blocks per MCU")
    if frame.progressive:
        if (ss > se or se > 63 or (ss == 0) != (se == 0) or al > 13
                or ah > 13 or (ss and n != 1)):
            frame.fail("bad progressive JPEG scan parameters")
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        frame.fail("bad sequential JPEG scan parameters")
    for ci in comps:
        c = frame.comps[ci]
        needs = []
        if ss == 0 and not (frame.progressive and ah):
            needs.append((0, c["td"]))
        if se:
            needs.append((1, c["ta"]))
        for key in needs:
            if key not in huff:
                frame.fail("JPEG scan without its Huffman table")
    return comps, huff, ss, se, ah, al


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3], as Pillow's ``convert("RGB")``:
    ``decode_jpeg_numpy`` through the C++ helper when it builds (a
    ``RuntimeWarning``, once, when it does not)."""
    frame = jpeg_header(data, name)
    lib = _helper("jpeg_decode", _bind_jpeg,
                  "JPEG frames are decoded with the numpy reference, whose "
                  "Huffman decoding loops in Python and is many times "
                  "slower")
    if lib is None:
        return decode_jpeg_numpy(data, name)
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), frame.height, frame.width, out, err,
                       len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_rgb(path: str | Path) -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3]: a JPEG or a PNG, told
    apart by their first bytes, as Pillow does (the extension is
    ignored)."""
    data = Path(path).read_bytes()
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, str(path))
    return decode_png(data, str(path))


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
