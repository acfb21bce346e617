"""Frames in the simple formats that ffmpeg's ``image2`` muxer writes,
read as the JAX package's two readers read them, bit for bit: Pillow 12.1.0
(the training loader's ``Image.open(path).convert("RGB")``) and OpenCV
5.0.0 (the eval's ``cv2.imread(path, IMREAD_COLOR |
IMREAD_IGNORE_ORIENTATION)``, or Pillow's where that returns None).

"Simple" means that a format stores its pixels raw, run-length coded or
(QOI) as a stream of byte ops: no transform and no entropy coder. The
formats: Netpbm (``P1``-``P6`` and Pillow's other ``PpmImagePlugin``
magics ``P0CMYK``, ``PyP``, ``PyRGBA``, ``PyCMYK``), PAM (``P7``), PFM
(``Pf`` grey, ``PF`` colour), Sun raster, TGA, SGI, PCX and DCX (its first
PCX page), QOI, XBM, Radiance HDR and DIB (a BMP without its file header,
``image_io._Bmp``).

Which reader reads what (the rest of a reader's refusals below):

- Pillow reads Netpbm, ``Pf``, Sun, TGA, SGI, PCX, DCX, QOI, XBM and DIB;
  it refuses PAM, ``PF`` and HDR, which the port's "pillow" reader then
  raises on;
- OpenCV reads ``P1``-``P6``, PAM, ``PF``, HDR and Sun of types 0 and 1
  (by their signatures); on everything else, and where it fails, the
  eval falls back to Pillow, as the port's "opencv" reader does.

Where the two readers' bits differ:

- Netpbm of maxval other than 255: Pillow scales samples to 0..255
  (``round(v / maxval * 255)``; grey of maxval above 255 is mode "I",
  scaled to 0..65535 and clipped to 255 by ``convert``), OpenCV keeps a
  binary file's samples (the high byte of a 16-bit one) and scales an
  ASCII file's as ``v * 255 // maxval`` (16-bit ones unscaled, high byte);
  OpenCV refuses an ASCII ``P2`` / ``P3`` whose last value has no
  whitespace after it (its ``ReadNumber`` reads past the end);
- PAM: OpenCV copies three-channel samples as they are into its BGR image,
  so the eval sees red and blue swapped; with 2 or 4 channels its
  ``basic_conversion`` fills only the first ceil(width / depth) pixels of
  each row and leaves the rest unset (the port gives them 0, what a
  freshly zeroed allocation holds); MAXVAL 1 is read as packed bits;
- ``Pf``: Pillow's "F" mode, which ``convert`` truncates to 0..255 with no
  x255 (OpenCV reads nothing); ``PF``: OpenCV divides by the scale's
  magnitude and rounds half to even, again with no x255;
- HDR: OpenCV's ``rgbe.cpp`` floats times 255, rounded half to even and
  saturated (a value past the 32-bit integer range gives 0, as
  ``cvRound`` gives INT_MIN there);
- Sun: OpenCV reads types 0 and 1 only (2, RLE, and 3, RGB order, go to
  Pillow); its 1-bit pixels are 0 black and 1 white (Pillow's "1;I": 1
  black) or its colour map's (Pillow raises on a 1-bit file with a map),
  its 32-bit pixels are X, B, G, R (Pillow's B, G, R, X).

Every reader here raises ``ValueError`` naming the file and the kind where
its library refuses the file: a truncated file, a bad header, a run past
its row. The loops that are slow in Python (the Sun, TGA, SGI and PCX
run-length decoders, QOI's op stream, HDR's scanlines and RGBE
conversion, the ASCII Netpbm tokenisers) run in the C++ helper
``csrc/simple_decode.cpp``; each has a reference here, named
``*_numpy``, that stands in for it when g++ is missing (a
``RuntimeWarning``, once).

Which plugin Pillow gives a file follows the order that a process which
imports ``PIL.Image`` alone sees (``pillow_open``): the six ``preinit``
plugins, then the rest of ``init``'s. A plugin whose ``_open`` raises
``SyntaxError``, ``IndexError``, ``TypeError``, ``KeyError``,
``EOFError`` or ``struct.error`` (``ImageFile.__init__`` turns the last
five into ``SyntaxError``) passes the file on; any other exception makes
``Image.open`` raise. So a TGA with a 10-byte image ID and no colour map,
whose first bytes PCX's ``_accept`` takes, raises as Pillow's PCX plugin
makes it raise, and an ICO or CUR with entries is refused as such. The
plugins that test no magic (IM, IMT, IPTC, PCD, SPIDER) are told by the
header checks of their ``_open``, which the port repeats to refuse such
a file by name.
"""

from __future__ import annotations

import ctypes
import math
import re
import struct

import numpy as np

WS = b" \t\n\x0b\x0c\r"                 # C isspace / Python bytes whitespace
SAFEBLOCK = 1024 * 1024                 # Pillow's ImageFile.SAFEBLOCK
# OpenCV's validateInputImageSize limits
CV_MAX_SIDE, CV_MAX_PIXELS = 1 << 20, 1 << 30


class PassOn(Exception):
    """A plugin's ``_open`` refused the file in a way that lets Pillow try
    the next plugin."""


class Pic:
    """A file as Pillow opens it: ``size`` (width, height), ``mode``,
    ``palette`` ([n, 3] for mode "P", else None) and ``load()``, which
    gives the pixels of the mode top row first ("1" as 0 / 255 bytes) or
    raises where Pillow's ``load`` raises."""

    def __init__(self, kind: str, size, mode: str, load, palette=None):
        self.kind, self.size, self.mode = kind, size, mode
        self.load, self.palette = load, palette


def _fail(name: str, what: str):
    raise ValueError(f"{name}: {what}")


def _i16le(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _i32le(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def _i16be(b, o=0):
    return struct.unpack_from(">H", b, o)[0]


def _i32be(b, o=0):
    return struct.unpack_from(">I", b, o)[0]


def _rows(data: bytes, offset: int, rows: int, stride: int, name: str,
          kind: str, last: int | None = None) -> np.ndarray:
    """``rows`` rows of ``stride`` bytes at ``offset`` as [rows, stride]
    uint8; a short file raises as Pillow's raw decoder does, which skips
    a row's padding before the next row, so that the last row needs only
    its ``last`` bytes (the padding it lacks reads 0)."""
    need = rows * stride - stride + (stride if last is None else last)
    if offset < 0 or offset + need > len(data):
        _fail(name, f"a truncated {kind} file (image file is truncated)")
    size = rows * stride
    if offset + size <= len(data):
        return np.frombuffer(data, np.uint8, size, offset).reshape(rows,
                                                                    stride)
    got = data[offset:] + bytes(offset + size - len(data))
    return np.frombuffer(got, np.uint8).reshape(rows, stride)


def _bits(rows: np.ndarray, width: int, bitorder: str = "big"):
    """The first ``width`` bits of each byte row as uint8 0 / 1."""
    return np.unpackbits(rows, axis=1, bitorder=bitorder)[:, :width]


def _cv_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of float32 values: ``cvRound``
    (half to even; INT_MIN for NaN, infinities and values past the int32
    range) clipped to 0..255."""
    v = np.asarray(v, np.float32)
    r = np.rint(v.astype(np.float64))
    bad = ~np.isfinite(r) | (r >= 2.0 ** 31) | (r < -2.0 ** 31)
    return np.where(bad, 0, np.clip(np.nan_to_num(r), 0, 255)).astype(
        np.uint8)


def _cv_validate(width: int, height: int, name: str, kind: str):
    """``imread``'s ``validateInputImageSize``, which runs outside its
    error handling: a size it refuses makes ``imread`` raise, so the JAX
    eval stops without falling back to Pillow."""
    if not (0 < width <= CV_MAX_SIDE and 0 < height <= CV_MAX_SIDE
            and width * height <= CV_MAX_PIXELS):
        _fail(name, f"a {kind} file of {width} x {height} pixels, a size "
              "OpenCV's imread raises on (the JAX eval stops there)")


# ---------------------------------------------------------------------------
# The loops, as numpy / plain-Python references (csrc/simple_decode.cpp runs
# the same loops)
# ---------------------------------------------------------------------------


def sun_rle_numpy(src: bytes, total: int):
    """Pillow's ``SunRleDecode.c`` over a continuous stream: ``0x80 0``
    is a literal 0x80, ``0x80 n v`` n + 1 copies of v (a run may cross
    rows), any other byte itself. -> (0 when ``total`` bytes came out, 1
    when the data ran out first; the bytes)."""
    if _cannot_fill(src, total, 86):           # 0x80 n v: 256 bytes of 3
        return 1, b""
    out = bytearray()
    i, n = 0, len(src)
    while len(out) < total:
        if i >= n:
            return 1, bytes(out)
        b = src[i]
        if b == 0x80:
            if i + 1 >= n:
                return 1, bytes(out)
            if src[i + 1] == 0:
                out.append(0x80)
                i += 2
            else:
                if i + 2 >= n:
                    return 1, bytes(out)
                out += bytes([src[i + 2]]) * (src[i + 1] + 1)
                i += 3
        else:
            out.append(b)
            i += 1
    return 0, bytes(out[:total])


def tga_rle_numpy(src: bytes, unit: int, row: int, total: int):
    """Pillow's ``TgaRleDecode.c``: a packet byte, then (bit 7 set) one
    pixel of ``unit`` bytes repeated (low 7 bits) + 1 times, or that many
    literal pixels, in rows of ``row`` bytes; a literal packet may cross
    rows, a run may not (Pillow's overrun error). -> (status as
    ``pcx_rle_numpy``'s, the bytes)."""
    if _cannot_fill(src, total, 128 * max(unit, 1)):
        return 1, b""
    out = bytearray()
    i, n = 0, len(src)
    while len(out) < total:
        if i >= n:
            return 1, bytes(out)
        count = (src[i] & 0x7F) + 1
        if src[i] & 0x80:
            if i + 1 + unit > n:
                return 1, bytes(out)
            if len(out) % row + unit * count > row:
                return 2, bytes(out)
            out += src[i + 1:i + 1 + unit] * count
            i += 1 + unit
        else:
            if i + 1 + unit * count > n:
                return 1, bytes(out)
            out += src[i + 1:i + 1 + unit * count]
            i += 1 + unit * count
    return 0, bytes(out[:total])


def pcx_rle_numpy(src: bytes, row_bytes: int, rows: int):
    """Pillow's ``PcxDecode.c``: a byte with its two top bits set runs
    its low 6 bits' count of the next byte, any other byte is itself; rows
    of ``row_bytes``. -> (0, 1 when the data ran out, 2 when a run passed
    the end of its row (Pillow's overrun error, raised once the image is
    read); the rows [rows, row_bytes] as decoded)."""
    if _cannot_fill(src, row_bytes * rows, 32):  # 2 bytes run 63
        return 1, np.zeros((0, row_bytes), np.uint8)
    out = np.zeros((rows, row_bytes), np.uint8)
    buf = bytearray(row_bytes)
    x = y = 0
    i, n, status = 0, len(src), 0
    while True:
        if i >= n:
            return 1, out
        b = src[i]
        if b & 0xC0 == 0xC0:
            if i + 1 >= n:
                return 1, out
            for _ in range(b & 0x3F):
                if x >= row_bytes:
                    status = 2
                    break
                buf[x] = src[i + 1]
                x += 1
            i += 2
        else:
            buf[x] = b
            x += 1
            i += 1
        if x >= row_bytes:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            x = 0
            y += 1
            if y >= rows:
                return status, out


def sgi_rle_numpy(data: bytes, xsize: int, ysize: int, bands: int,
                  bpc: int):
    """Pillow's ``SgiRleDecode.c`` over ``data`` (the file after its
    512-byte header): the start and length tables, then each row of each
    channel expanded into one row buffer that the rows share (a row that
    ends early keeps the previous row's samples). -> (0; 1 when a row's
    chunk count ran out first (Pillow stops there without an error, the
    rows not reached left 0); 2 on Pillow's overrun errors; rows
    [ysize, xsize * bands * bpc] in table order, the bottom row first). A
    row's table length bounds its chunk count only: Pillow checks its
    reads against the data's end, not offset + length."""
    out = np.zeros((ysize, xsize * bands * bpc), np.uint8)
    tablen = bands * ysize
    n = len(data)
    if n < 8 * tablen:
        return 2, out
    start = struct.unpack_from(f">{tablen}I", data, 0)
    length = struct.unpack_from(f">{tablen}I", data, 4 * tablen)
    buf = bytearray(xsize * bands * bpc)
    end = n - 1                           # Pillow's end_of_buffer index
    for row in range(ysize):
        for ch in range(bands):
            off, cnt = start[row + ch * ysize], length[row + ch * ysize]
            if off < 512:
                return 2, out
            off -= 512
            status = _sgi_expand(data, off, _int32(cnt), buf, ch, bands,
                                 xsize, end, bpc)     # an int in C
            if status == -1:
                return 2, out
            if status == 1:
                return 1, out
        out[row] = np.frombuffer(bytes(buf), np.uint8)
    return 0, out


def _sgi_expand(src, s, chunks, buf, ch, z, xsize, end, bpc) -> int:
    """``expandrow`` / ``expandrow2``: -1 overrun, 1 the last chunk was
    not a terminator, 0 done."""
    x = 0
    d = ch * bpc
    step = z * bpc
    while chunks > 0:
        if s + bpc - 1 > end:
            return -1
        pixel = src[s + bpc - 1]
        s += bpc
        if chunks == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        x += count
        if pixel & 0x80:
            if s + bpc * count > end:
                return -1
            for _ in range(count):
                buf[d:d + bpc] = src[s:s + bpc]
                s += bpc
                d += step
        else:
            if s + (0 if bpc == 1 else 2) > end:
                return -1
            v = src[s:s + bpc]
            for _ in range(count):
                buf[d:d + bpc] = v
                d += step
            s += bpc
        chunks -= 1
    return 0


QOI_HASH = (3, 5, 7, 11)


def qoi_numpy(src: bytes, pixels: int, bands: int):
    """Pillow's ``QoiDecoder`` (not the reference decoder): INDEX of an
    entry never set gives (0, 0, 0, 0), RUN does not enter the index, the
    end marker is not looked at. -> (0, or 1 when the data ran out; the
    ``pixels * bands`` bytes)."""
    if _cannot_fill(src, pixels, 62):          # a RUN byte: 62 pixels
        return 1, b""
    seen: dict = {}
    prev = (0, 0, 0, 255)
    out = bytearray()
    want = pixels * bands
    i, n = 0, len(src)
    while len(out) < want:
        if i >= n:
            return 1, bytes(out)
        b = src[i]
        i += 1
        if b == 0xFE:
            if i + 3 > n:
                return 1, bytes(out)
            v = (src[i], src[i + 1], src[i + 2], prev[3])
            i += 3
        elif b == 0xFF:
            if i + 4 > n:
                return 1, bytes(out)
            v = tuple(src[i:i + 4])
            i += 4
        else:
            op = b >> 6
            if op == 0:
                v = seen.get(b & 63, (0, 0, 0, 0))
            elif op == 1:
                v = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
            elif op == 2:
                if i >= n:
                    return 1, bytes(out)
                b2 = src[i]
                i += 1
                dg = (b & 63) - 32
                v = ((prev[0] + dg + (b2 >> 4) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
            else:
                out += bytes(prev[:bands]) * ((b & 63) + 1)
                continue
        prev = v
        seen[sum(c * k for c, k in zip(v, QOI_HASH)) % 64] = v
        out += bytes(v[:bands])
    return 0, bytes(out[:want])


def _rgbe_floats(q: np.ndarray) -> np.ndarray:
    """``rgbe2float`` of [n, 4] bytes -> [n, 3] float32 (R, G, B)."""
    e = q[:, 3].astype(np.int32)
    f = np.ldexp(np.ones(len(q)), e - 136).astype(np.float32)
    out = q[:, :3].astype(np.float32) * f[:, None]
    out[e == 0] = 0
    return out


def _hdr_short(src: bytes, width: int, height: int) -> bool:
    """Whether ``src`` is shorter than any ``height`` scanlines can be:
    4 bytes a flat pixel, or a scanline header and two bytes a run of up
    to 127 per channel."""
    least = 4 * width if width < 8 else min(4 * width,
                                             4 + 8 * -(-width // 127))
    return len(src) < height * least


def hdr_numpy(src: bytes, width: int, height: int):
    """``RGBE_ReadPixels_RLE`` of OpenCV's ``rgbe.cpp``: flat RGBE pixels
    when the width is under 8 or past 0x7fff, or from the first pixel
    that is not a new-style scanline header (2, 2, width high, low) on;
    else each scanline's four channels run-length coded (a count past 128
    runs the next byte, else that many literal bytes). Old-style runs
    (1, 1, 1, n) are read as pixels. -> (0, 1 when the data ran out, 2
    on a bad scanline; float32 [height, width, 3] R, G, B)."""
    if _hdr_short(src, width, height):         # never allocate past it
        return 1, np.zeros((0, width, 3), np.float32)
    out = np.zeros((height * width, 3), np.float32)
    total = width * height
    pos, done = 0, 0

    def flat(count):
        nonlocal pos, done
        nb = min(count, (len(src) - pos) // 4)
        q = np.frombuffer(src, np.uint8, 4 * nb, pos).reshape(nb, 4)
        out[done:done + nb] = _rgbe_floats(q)
        pos += 4 * nb
        done += nb
        return 0 if nb == count else 1

    if width < 8 or width > 0x7FFF:
        return flat(total), out.reshape(height, width, 3)
    line = bytearray(4 * width)
    for _ in range(height):
        if pos + 4 > len(src):
            return 1, out.reshape(height, width, 3)
        r = src[pos:pos + 4]
        if r[0] != 2 or r[1] != 2 or r[2] & 0x80:
            return flat(total - done), out.reshape(height, width, 3)
        if (r[2] << 8 | r[3]) != width:
            return 2, out.reshape(height, width, 3)
        pos += 4
        p = 0
        for ch in range(4):
            stop = (ch + 1) * width
            while p < stop:
                if pos + 2 > len(src):
                    return 1, out.reshape(height, width, 3)
                c, v = src[pos], src[pos + 1]
                pos += 2
                if c > 128:
                    c -= 128
                    if c == 0 or c > stop - p:
                        return 2, out.reshape(height, width, 3)
                    line[p:p + c] = bytes([v]) * c
                    p += c
                else:
                    if c == 0 or c > stop - p:
                        return 2, out.reshape(height, width, 3)
                    line[p] = v
                    p += 1
                    if c > 1:
                        if pos + c - 1 > len(src):
                            return 1, out.reshape(height, width, 3)
                        line[p:p + c - 1] = src[pos:pos + c - 1]
                        p += c - 1
                        pos += c - 1
        q = np.frombuffer(bytes(line), np.uint8).reshape(4, width).T
        out[done:done + width] = _rgbe_floats(q)
        done += width
    return 0, out.reshape(height, width, 3)


def _strip_comments(block: bytes, spans: bool = False):
    """Pillow's plain-PPM comment removal: from each ``#`` through the
    next CR or LF (to the end where there is none; ``spans``: the block
    starts inside a comment). -> (the block without them, whether a
    comment runs on past its end)."""
    out = bytearray()
    i = 0
    while True:
        j = 0 if spans and i == 0 else block.find(b"#", i)
        if j < 0:
            out += block[i:]
            return bytes(out), False
        out += block[i:j]
        a, b = block.find(b"\n", j), block.find(b"\r", j)
        end = min(a, b) if a * b > 0 else max(a, b)
        if end < 0:
            return bytes(out), True
        i = end + 1
        spans = False


def pnm_pillow_numpy(src: bytes, count: int, maxval: int, bitonal: bool):
    """Pillow's ``PpmPlainDecoder``: comments removed, then either
    (``bitonal``, P1) every other non-whitespace byte a value, each
    ``0`` or ``1`` (checked over each 1 MiB block read), or
    whitespace-separated decimal tokens of at most 10 characters, each at
    most ``maxval``. -> (0, 1 when the values ran out, or 2 on a token
    Pillow refuses; int64 values)."""
    if len(src) < count:                       # a byte or more a value
        return 1, np.zeros(0, np.int64)
    vals: list = []
    if bitonal:
        spans = False
        for k in range(0, max(len(src), 1), SAFEBLOCK):
            block, spans = _strip_comments(src[k:k + SAFEBLOCK], spans)
            toks = b"".join(block.split())
            if any(t not in b"01" for t in toks):
                return 2, np.array(vals, np.int64)
            vals.extend(t - 48 for t in toks)
            if len(vals) >= count:
                return 0, np.array(vals[:count], np.int64)
        return 1, np.array(vals, np.int64)
    for tok in _strip_comments(src)[0].split():
        if len(tok) > 10:
            return 2, np.array(vals, np.int64)
        try:
            v = int(tok)
        except ValueError:
            return 2, np.array(vals, np.int64)
        if v < 0 or v > maxval:
            return 2, np.array(vals, np.int64)
        vals.append(v)
        if len(vals) == count:
            return 0, np.array(vals, np.int64)
    return 1, np.array(vals, np.int64)


def read_number(src: bytes, pos: int, maxdigits: int = 0):
    """OpenCV's ``ReadNumber`` at ``pos``: whitespace and ``#`` comments
    (to CR or LF) skipped, any other non-digit an error; digits up to
    ``maxdigits`` (0: all), then one more byte read past them, which must
    exist. -> (value, position after it), or None on an error."""
    n = len(src)
    if pos >= n:
        return None
    c = src[pos]
    pos += 1
    while not 48 <= c <= 57:
        if c == 35:
            while True:
                if pos >= n:
                    return None
                c = src[pos]
                pos += 1
                if c in (10, 13):
                    break
            if pos >= n:
                return None
            c = src[pos]
            pos += 1
        elif c in WS:
            while c in WS:
                if pos >= n:
                    return None
                c = src[pos]
                pos += 1
        else:
            return None
    v = digits = 0
    while True:
        v = v * 10 + c - 48
        if v > 2 ** 31 - 1:
            return None
        digits += 1
        if maxdigits and digits >= maxdigits:
            return v, pos
        if pos >= n:
            return None
        c = src[pos]
        pos += 1
        if not 48 <= c <= 57:
            return v, pos


def pnm_opencv_numpy(src: bytes, count: int, maxdigits: int):
    """``read_number`` ``count`` times over ASCII Netpbm samples. -> (0,
    or 1 on an error; int64 values)."""
    if len(src) < count:                       # a byte or more a value
        return 1, np.zeros(0, np.int64)
    vals, pos = [], 0
    for _ in range(count):
        got = read_number(src, pos, maxdigits)
        if got is None:
            return 1, np.array(vals, np.int64)
        v, pos = got
        vals.append(v)
    return 0, np.array(vals, np.int64)


# ---------------------------------------------------------------------------
# The C++ helper
# ---------------------------------------------------------------------------


def _bind(lib):
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64, cp = ctypes.c_int64, ctypes.c_char_p
    for fn, args in (("simple_sun_rle", [cp, i64, i64, p_u8]),
                     ("simple_tga_rle", [cp, i64, i64, i64, i64, p_u8,
                                         p_i64]),
                     ("simple_pcx_rle", [cp, i64, i64, i64, p_u8]),
                     ("simple_sgi_rle", [cp, i64, i64, i64, i64, i64, p_u8]),
                     ("simple_qoi", [cp, i64, i64, i64, p_u8]),
                     ("simple_hdr", [cp, i64, i64, i64, p_f32]),
                     ("simple_pnm_pillow", [cp, i64, i64, i64, i64, p_i64,
                                            p_i64]),
                     ("simple_pnm_opencv", [cp, i64, i64, i64, p_i64])):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = args


def _lib():
    from . import image_io               # image_io imports this module

    return image_io._helper(
        "simple_decode", _bind,
        "Netpbm, Sun, TGA, SGI, PCX, QOI and HDR frames are decoded with the "
        "numpy references, whose loops run in Python and are many times "
        "slower")


def _cannot_fill(src: bytes, total: int, most: int) -> bool:
    """Whether ``src`` is too short to expand to ``total`` bytes when no
    input byte gives more than ``most``: the decoders then run out, and a
    corrupt header's huge size is never allocated."""
    return len(src) * most < total


def sun_rle(src: bytes, total: int):
    """``sun_rle_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or _cannot_fill(src, total, 86):
        return sun_rle_numpy(src, total)
    out = np.zeros(total, np.uint8)
    got = lib.simple_sun_rle(src, len(src), total, out)
    return (0 if got == total else 1), out[:got].tobytes()


def tga_rle(src: bytes, unit: int, row: int, total: int):
    """``tga_rle_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or _cannot_fill(src, total, 128 * max(unit, 1)):
        return tga_rle_numpy(src, unit, row, total)
    out = np.zeros(total, np.uint8)
    status = np.zeros(1, np.int64)
    got = lib.simple_tga_rle(src, len(src), unit, row, total, out, status)
    return int(status[0]), out[:got].tobytes()


def pcx_rle(src: bytes, row_bytes: int, rows: int):
    """``pcx_rle_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or _cannot_fill(src, row_bytes * rows, 32):
        return pcx_rle_numpy(src, row_bytes, rows)
    out = np.zeros((rows, row_bytes), np.uint8)
    return int(lib.simple_pcx_rle(src, len(src), row_bytes, rows, out)), out


def sgi_rle(data: bytes, xsize: int, ysize: int, bands: int, bpc: int):
    """``sgi_rle_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None:
        return sgi_rle_numpy(data, xsize, ysize, bands, bpc)
    out = np.zeros((ysize, xsize * bands * bpc), np.uint8)
    status = lib.simple_sgi_rle(data, len(data), xsize, ysize, bands, bpc,
                                out)
    return int(status), out


def qoi(src: bytes, pixels: int, bands: int):
    """``qoi_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or _cannot_fill(src, pixels, 62):
        return qoi_numpy(src, pixels, bands)
    out = np.zeros(pixels * bands, np.uint8)
    got = lib.simple_qoi(src, len(src), pixels, bands, out)
    return (0 if got == pixels * bands else 1), out[:got].tobytes()


def hdr(src: bytes, width: int, height: int):
    """``hdr_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or _hdr_short(src, width, height):
        return hdr_numpy(src, width, height)
    out = np.zeros((height, width, 3), np.float32)
    return int(lib.simple_hdr(src, len(src), width, height, out)), out


def pnm_pillow(src: bytes, count: int, maxval: int, bitonal: bool):
    """``pnm_pillow_numpy`` through the C++ helper when it builds (a token
    that is not plain digits goes to the reference, for Python's
    ``int``)."""
    lib = _lib()
    if lib is not None and len(src) >= count:
        out = np.zeros(max(count, 1), np.int64)
        status = np.zeros(1, np.int64)
        got = lib.simple_pnm_pillow(src, len(src), count, maxval,
                                    int(bitonal), out, status)
        if status[0] >= 0:
            return int(status[0]), out[:got]
    return pnm_pillow_numpy(src, count, maxval, bitonal)


def pnm_opencv(src: bytes, count: int, maxdigits: int):
    """``pnm_opencv_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None or len(src) < count:
        return pnm_opencv_numpy(src, count, maxdigits)
    out = np.zeros(max(count, 1), np.int64)
    got = lib.simple_pnm_opencv(src, len(src), count, maxdigits, out)
    return (0 if got == count else 1), out[:max(got, 0)]


# ---------------------------------------------------------------------------
# Netpbm, PFM (Pillow's PpmImagePlugin; OpenCV's grfmt_pxm.cpp,
# grfmt_pfm.cpp) and PAM (grfmt_pam.cpp)
# ---------------------------------------------------------------------------

PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
             b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
             b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "LA": 2, "RGB": 3,
          "RGBA": 4, "CMYK": 4}


def _ppm_token(data: bytes, pos: int, name: str):
    """``PpmImageFile._read_token`` -> (token, position after it)."""
    tok = b""
    while len(tok) <= 10:
        c = data[pos:pos + 1]
        if not c:
            break
        pos += 1
        if c in WS:
            if not tok:
                continue
            break
        if c == b"#":
            while True:
                c = data[pos:pos + 1]
                if c:
                    pos += 1
                if c in b"\r\n":
                    break
            continue
        tok += c
    if not tok:
        _fail(name, "a PPM file whose header ends early (reached EOF while "
              "reading header)")
    if len(tok) > 10:
        _fail(name, "a PPM file with a header token too long")
    return tok, pos


def _ppm_int(tok: bytes, name: str) -> int:
    try:
        return int(tok)
    except ValueError:
        _fail(name, f"a PPM file with a bad header value {tok[:12]!r}")


def _ppm_open(data: bytes, name: str) -> Pic:
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        if c:
            pos += 1
        if not c or c in WS:
            break
        magic += c
    if magic not in PPM_MODES:
        raise PassOn
    mode = PPM_MODES[magic]
    tok, pos = _ppm_token(data, pos, name)
    w = _ppm_int(tok, name)
    tok, pos = _ppm_token(data, pos, name)
    h = _ppm_int(tok, name)
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = 1
    if mode == "F":
        tok, pos = _ppm_token(data, pos, name)
        try:
            scale = float(tok)
        except ValueError:
            _fail(name, f"a PFM file with a bad scale {tok!r}")
        if scale == 0.0 or not math.isfinite(scale):
            _fail(name, "a PFM file whose scale is zero or not finite")
        little = scale < 0
    elif mode != "1":
        tok, pos = _ppm_token(data, pos, name)
        maxval = _ppm_int(tok, name)
        if not 0 < maxval < 65536:
            _fail(name, f"a PPM file of maxval {maxval}, not 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    start = pos

    def load():
        bands = _BANDS[mode]
        if mode == "F":
            raw = _rows(data, start, h, 4 * w, name, "PFM")
            px = raw.copy().view("<f4" if little else ">f4").astype(
                np.float32)
            return px[::-1].copy()
        if plain:
            count = w * h * bands
            status, vals = pnm_pillow(data[start:], count, maxval,
                                      mode == "1")
            if status == 2:
                _fail(name, "a plain PPM file with a value Pillow refuses "
                      "(not a digit, too long, or past its maxval)")
            if status == 1:
                _fail(name, "a truncated plain PPM file (not enough image "
                      "data)")
            if mode == "1":
                return np.where(vals == 0, 255, 0).astype(np.uint8).reshape(
                    h, w)
            top = 65535 if mode == "I" else 255
            v = np.rint(vals / maxval * top)
            return _shape(v.astype(np.int32 if mode == "I" else np.uint8),
                          h, w, bands)
        if mode == "1":
            rows = _rows(data, start, h, (w + 7) // 8, name, "PBM")
            return ((1 - _bits(rows, w)) * 255).astype(np.uint8)
        if mode == "I" and maxval == 65535:
            raw = _rows(data, start, h, 2 * w, name, "PGM")
            return raw.copy().view(">u2").astype(np.int32)
        if maxval == 255:
            raw = _rows(data, start, h, w * bands, name, "PPM")
            return _shape(raw, h, w, bands)
        nb = 1 if maxval < 256 else 2
        npix = min(w * h, (len(data) - start) // (nb * bands))
        if npix < w * h:
            _fail(name, "a truncated PPM file (not enough image data)")
        v = np.frombuffer(data, ">u2" if nb == 2 else np.uint8,
                          w * h * bands, start).astype(np.float64)
        top = 65535 if mode == "I" else 255
        v = np.minimum(top, np.rint(v / maxval * top))
        return _shape(v.astype(np.int32 if mode == "I" else np.uint8), h, w,
                      bands)

    palette = np.zeros((0, 3), np.uint8) if mode == "P" else None
    return Pic("PPM", (w, h), mode, load, palette)


def _shape(px: np.ndarray, h: int, w: int, bands: int) -> np.ndarray:
    return px.reshape(h, w) if bands == 1 else px.reshape(h, w, bands)


def _pxm_opencv(data: bytes, name: str):
    """``PxMDecoder`` (P1-P6) as RGB, or None where ``imread`` gives
    None."""
    code = data[1]
    bpp = {49: 1, 52: 1, 50: 8, 53: 8, 51: 24, 54: 24}[code]
    binary = code >= 52
    head, pos = [], 2
    for _ in range(3 if bpp > 1 else 2):
        got = read_number(data, pos)
        if got is None:
            return None
        head.append(got[0])
        pos = got[1]
    w, h, maxval = head + [1] * (bpp == 1)
    if maxval > 65535 or maxval <= 0 or w <= 0 or h <= 0:
        return None
    _cv_validate(w, h, name, "Netpbm")
    nch = 3 if bpp == 24 else 1
    body = data[pos:]
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            if len(body) < pitch * h:
                return None
            rows = np.frombuffer(body, np.uint8, pitch * h).reshape(h, pitch)
            bit = _bits(rows, w)
        else:
            status, vals = pnm_opencv(body, w * h, 1)
            if status:
                return None
            bit = (vals != 0).reshape(h, w)
        g = np.where(bit != 0, 0, 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, -1)
    wide = maxval > 255
    count = w * h * nch
    if binary:
        nb = 2 if wide else 1
        if len(body) < count * nb:
            return None
        if wide:
            v = np.frombuffer(body, np.uint8, 2 * count)[0::2]
        else:
            v = np.frombuffer(body, np.uint8, count)
    else:
        status, vals = pnm_opencv(body, count, 0)
        if status:
            return None
        vals = np.minimum(vals, maxval)
        v = ((vals >> 8) if wide else vals * 255 // maxval).astype(np.uint8)
    v = v.reshape(h, w, nch)
    return np.ascontiguousarray(np.repeat(v, 3, -1) if nch == 1 else v)


def _pfm_opencv(data: bytes, name: str):
    """``PFMDecoder``: "PF" as RGB (divided by the scale's magnitude,
    rounded half to even); "Pf" gives None (``imread`` cannot put one
    channel into its colour image)."""
    if data[1:2] != b"F":
        return None

    def token(pos):
        j = pos
        while j < len(data) and j - pos < 2048 and data[j] not in WS:
            if data[j] >= 128:
                return None, j
            j += 1
        if j >= len(data):
            return None, j
        return data[pos:j], j + 1

    w_tok, pos = token(3)
    h_tok, pos = token(pos) if w_tok is not None else (None, 0)
    s_tok, pos = token(pos) if h_tok is not None else (None, 0)
    if s_tok is None:
        return None
    m = re.match(rb"\s*([+-]?\d+)", w_tok), re.match(rb"\s*([+-]?\d+)",
                                                      h_tok)
    w, h = (int(x.group(1)) if x else 0 for x in m)
    f = re.match(rb"\s*([+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)", s_tok)
    scale = float(f.group(1)) if f else 0.0
    _cv_validate(w, h, name, "PFM")
    if scale == 0.0:
        return None
    need = 12 * w * h
    if len(data) - pos < need:
        return None
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", 3 * w * h,
                      pos).astype(np.float32).reshape(h, w, 3)[::-1]
    v = v * np.float32(1.0 / abs(scale))
    return _cv_u8(v)


PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
# TUPLTYPE -> (the DEPTH OpenCV requires of it, the channels (r, g, b) its
# basic_conversion takes)
PAM_TYPES = {"BLACKANDWHITE": (1, (0, 0, 0)), "GRAYSCALE": (1, (0, 0, 0)),
             "GRAYSCALE_ALPHA": (2, (0, 0, 0)), "RGB": (3, (0, 1, 2)),
             "RGB_ALPHA": (4, (0, 1, 2))}


def _pam_number(s: bytes):
    """A PAM header value as OpenCV's ``ParseNumber`` takes it: decimal
    digits, a minus sign allowed, nothing else, in the int range -> value
    or None."""
    v = int(s) if re.fullmatch(rb"-?[0-9]+", s) else None
    return v if v is not None and -2 ** 31 <= v < 2 ** 31 else None


def _pam_header(data: bytes):
    """``PAMDecoder::readHeader`` -> (width, height, depth, maxval, tuple
    type, offset) or None; a TUPLTYPE whose channels are not DEPTH's is
    refused."""
    if data[:3] not in (b"P7\n", b"P7\r"):
        return None
    pos, n = 3, len(data)
    got: dict = {}
    while True:
        while pos < n and data[pos] in WS:
            pos += 1
        if pos >= n:
            return None
        c = data[pos]
        pos += 1
        if c == 35:
            while pos < n and data[pos] not in (10, 13):
                pos += 1
            if pos >= n:
                return None
            pos += 1
            continue
        ident = bytearray()
        while len(ident) < 8 and c not in WS:
            ident.append(c)
            if pos >= n:
                return None
            c = data[pos]
            pos += 1
        if c not in WS:
            return None
        key = bytes(ident).decode("latin-1")
        if key not in PAM_FIELDS:
            return None
        value = b""
        if c not in (10, 13):
            while pos < n and data[pos] in WS:
                pos += 1
            if pos >= n:
                return None
            c = data[pos]
            pos += 1
            val = bytearray()
            while len(val) < 255 and c not in (10, 13):
                val.append(c)
                if pos >= n:
                    return None
                c = data[pos]
                pos += 1
            if c not in (10, 13):
                return None
            value = bytes(val).rstrip(WS)
        if key == "ENDHDR":
            break
        if key == "TUPLTYPE":
            t = value.decode("latin-1")
            if t and t not in PAM_TYPES:
                return None
            got[key] = t
            continue
        if key in got:
            return None
        v = _pam_number(value)
        if v is None:
            return None
        got[key] = v
        if key == "MAXVAL" and got[key] > 65535:
            return None
    if not all(k in got for k in ("HEIGHT", "WIDTH", "DEPTH", "MAXVAL")):
        return None
    w, h, depth, maxval = (got[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                            "MAXVAL"))
    tupl = got.get("TUPLTYPE", "")
    if tupl == "":
        if depth == 1 and maxval == 1:
            tupl = "BLACKANDWHITE"
        elif depth == 1 and maxval < 256:
            tupl = "GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupl = "RGB"
        else:
            return None
    if not 1 <= depth <= 4 or PAM_TYPES[tupl][0] != depth:
        return None
    return w, h, depth, maxval, tupl, pos


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _pam_opencv(data: bytes, name: str):
    """``PAMDecoder`` as RGB (what the eval gets after its BGR to RGB
    flip), or None; ``pam_unset`` gives the pixels it leaves unset."""
    hdr = _pam_header(data)
    if hdr is None:
        return None
    w, h, depth, maxval, tupl, pos = hdr
    _cv_validate(w, h, name, "PAM")
    wide = maxval > 255
    stride = w * depth * (2 if wide else 1)
    if len(data) - pos < stride * h:
        return None
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
    if maxval == 1:
        bit = _bits(rows, w)
        g = (bit * 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, -1)
    s = rows[:, 0::2] if wide else rows          # high bytes
    if depth == 3:
        return np.ascontiguousarray(s.reshape(h, w, 3)[..., ::-1])
    r, g, b = PAM_TYPES[tupl][1]
    n = -(-w // depth)
    px = s[:, :n * depth].reshape(h, n, depth)
    out = np.zeros((h, w, 3), np.uint8)
    out[:, :n] = px[..., [r, g, b]]
    return out


def pam_unset(data: bytes) -> int | None:
    """The columns from which OpenCV leaves a PAM's rows unset (its
    ``basic_conversion`` walks width / depth pixels), or None where it
    sets every pixel (or reads nothing)."""
    hdr = _pam_header(data)
    if hdr is None:
        return None
    w, _, depth, maxval, tupl, _ = hdr
    if maxval == 1 or depth in (1, 3):
        return None
    n = -(-w // depth)
    return n if n < w else None


# ---------------------------------------------------------------------------
# Sun raster (SunImagePlugin; grfmt_sunras.cpp)
# ---------------------------------------------------------------------------

SUN_MAGIC = 0x59A66A95


def _sun_open(data: bytes, name: str) -> Pic:
    if len(data) < 32:
        raise PassOn
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if ftype == 3 else "BGR"),
             32: ("RGB", "RGBX" if ftype == 3 else "BGRX")}
    if depth not in modes:
        raise PassOn
    mode, rawmode = modes[depth]
    offset = 32
    palette = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise PassOn
        offset += plen
        pal = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(pal) // 3
        palette = pal[:3 * n].reshape(3, n).T.copy()
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise PassOn
    stride = ((w * depth + 15) // 16) * 2

    def load():
        if palette is not None and len(palette) > 256:
            _fail(name, f"a Sun raster file whose colour map has "
                  f"{len(palette)} entries (invalid palette size)")
        if palette is not None and mode != "P":
            _fail(name, f"a Sun raster file of {depth} bits with a colour "
                  "map, which Pillow cannot put on its image (unrecognized "
                  "image mode)")
        row = (w * depth + 7) // 8
        if ftype == 2:
            status, buf = sun_rle(data[offset:], row * h)
            if status:
                _fail(name, "a truncated Sun raster file (its RLE data ends "
                      "early)")
            rows = np.frombuffer(buf, np.uint8).reshape(h, row)
        else:
            rows = _rows(data, offset, h, stride, name, "Sun raster", row)
        return _sun_unpack(rows, rawmode, w)

    return Pic("SUN", (w, h), mode, load, palette)


def _sun_unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    if rawmode == "1;I":
        return ((1 - _bits(rows, w)) * 255).astype(np.uint8)
    if rawmode in ("L;4", "P;4"):
        v = np.stack([rows >> 4, rows & 15], -1).reshape(len(rows), -1)[:, :w]
        return v * np.uint8(17) if rawmode == "L;4" else v
    if rawmode in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    k = 4 if rawmode.endswith("X") else 3
    px = rows[:, :k * w].reshape(len(rows), w, k)[..., :3]
    return np.ascontiguousarray(px if rawmode.startswith("RGB")
                                else px[..., ::-1])


def _sun_opencv(data: bytes, name: str):
    """``SunRasterDecoder`` as RGB, or None: types 0 and 1 only (its
    check of the RLE and RGB types reads the wrong field), 1, 8, 24 and 32
    bits; a colour map only at 1 and 8 bits and at most 2^bits entries."""
    if len(data) < 32:
        return None
    w, h, bpp, _, enc, mtype, mlen = (_int32(v) for v in struct.unpack_from(
        ">7I", data, 4))
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    ok = (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and enc in (0, 1)
          and ((mtype == 0 and mlen == 0)
               or (mtype == 1 and 0 < mlen <= pal_size and bpp <= 8)))
    if not ok:
        return None
    _cv_validate(w, h, name, "Sun raster")
    if mlen:
        if len(data) < 32 + mlen:
            return None
        n = mlen // 3
        pal = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = pal
    else:
        levels = 1 << min(bpp, 8)
        g = (np.arange(256) * 255 // max(levels - 1, 1)).clip(0, 255)
        lut = np.repeat(g.astype(np.uint8)[:, None], 3, 1)
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    body = 32 + mlen
    if len(data) - body < pitch * h:
        return None
    rows = np.frombuffer(data, np.uint8, pitch * h, body).reshape(h, pitch)
    if bpp == 1:
        return lut[_bits(rows, w)]
    if bpp == 8:
        return lut[rows[:, :w]]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[
            ..., ::-1])
    return np.ascontiguousarray(rows[:, :4 * w].reshape(h, w, 4)[
        ..., 3:0:-1])


# ---------------------------------------------------------------------------
# TGA (TgaImagePlugin; OpenCV reads none)
# ---------------------------------------------------------------------------

TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
                (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """Pillow's "BGRA;15Z" unpacker over little-endian 16-bit values ->
    RGBA (5-bit channels * 255 // 31, alpha 255 where bit 15 is clear)."""
    v = v.astype(np.int32)
    c = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return np.stack(c + [np.where(v >> 15, 0, 255)], -1).astype(np.uint8)


def _tga_open(data: bytes, name: str) -> Pic:
    if len(data) < 18:
        raise PassOn
    s = data[:18]
    id_len, cmtype, itype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = _i16le(s, 12), _i16le(s, 14)
    if cmtype not in (0, 1) or w <= 0 or h <= 0 or depth not in (
            1, 8, 16, 24, 32):
        raise PassOn
    if itype in (3, 11):
        mode = "1" if depth == 1 else "LA" if depth == 16 else "L"
    elif itype in (1, 9):
        mode = "P" if cmtype else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise PassOn
    orient = flags & 0x30
    flip = orient in (0x10, 0x30)
    top_down = orient in (0x20, 0x30)
    pos = 18 + id_len
    palette, mdepth = None, 0
    if cmtype:
        start, size, mdepth = _i16le(s, 3), _i16le(s, 5), s[7]
        if mdepth not in (16, 24, 32):
            raise PassOn
        k = mdepth // 8
        raw = bytes(k * start) + data[pos:pos + k * size]
        pos = min(pos + k * size, len(data))
        ent = np.frombuffer(raw[:len(raw) // k * k], np.uint8).reshape(-1, k)
        if k == 2:
            palette = _bgra15z(ent.copy().view("<u2")[:, 0])[:, :3]
        else:
            palette = np.ascontiguousarray(ent[:, 2::-1])
    rawmode = TGA_RAWMODES.get((itype & 7, depth))
    # Pillow puts a colour map on an "L" / "LA" image as it loads, which
    # makes it "P" / "PA"
    pmode = {"L": "P", "LA": "PA"}.get(mode, mode) if palette is not None \
        and rawmode != "P" else mode

    def load():
        if rawmode is None:
            _fail(name, f"a TGA file of image type {itype} at {depth} bits, "
                  "which Pillow cannot load")
        if palette is not None and len(palette) > 256:
            _fail(name, f"a TGA file whose colour map reaches entry "
                  f"{len(palette) - 1} (invalid palette size)")
        if palette is not None and mdepth == 32:
            _fail(name, "a TGA file with a colour map of 32-bit entries, "
                  "which Pillow cannot load (unrecognized raw mode)")
        if palette is not None and pmode not in ("P", "PA"):
            _fail(name, f"a TGA file of mode {mode} with a colour map, which "
                  "Pillow cannot put on its image")
        if mode == "L" and rawmode == "P":
            _fail(name, "a colour-mapped TGA file without a colour map "
                  "(Pillow has no unpacker from P to L)")
        unit = depth // 8             # 0 at 1 bit: Pillow never ends
        row = (w * depth + 7) // 8
        if itype & 8:
            status, buf = tga_rle(data[pos:], unit, row, row * h)
            if status == 1:
                _fail(name, "a truncated TGA file (its RLE data ends early)")
            if status == 2:
                _fail(name, "a TGA file with an RLE run past the end of its "
                      "row (buffer overrun)")
            rows = np.frombuffer(buf, np.uint8).reshape(h, row)
        else:
            rows = _rows(data, pos, h, row, name, "TGA")
        if rawmode == "1":
            px = (_bits(rows, w) * 255).astype(np.uint8)
        elif rawmode in ("P", "L"):
            px = rows[:, :w]
        elif rawmode == "LA":
            px = rows.reshape(h, w, 2)
        elif rawmode == "BGRA;15Z":
            px = _bgra15z(rows.copy().view("<u2"))
        elif rawmode == "BGR":
            px = rows.reshape(h, w, 3)[..., ::-1]
        else:
            px = rows.reshape(h, w, 4)[..., [2, 1, 0, 3]]
        if not top_down:
            px = px[::-1]
        if flip:
            px = px[:, ::-1]
        return np.ascontiguousarray(px)

    return Pic("TGA", (w, h), pmode, load, palette)


# ---------------------------------------------------------------------------
# SGI (SgiImagePlugin; OpenCV reads none)
# ---------------------------------------------------------------------------

SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
             (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
             (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _sgi_open(data: bytes, name: str) -> Pic:
    if len(data) < 12:
        raise PassOn
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    rawmode = SGI_MODES.get((bpc, dim, z))
    if rawmode is None:
        _fail(name, f"an SGI file of {bpc} bytes a sample, dimension {dim} "
              f"and {z} channels, which Pillow does not read (unsupported "
              "SGI image mode)")
    mode = rawmode.split(";")[0]
    bands = len(mode)

    def load():
        if comp == 0:
            page = w * h * bpc
            planes = [_rows(data, 512 + k * page, h, w * bpc, name, "SGI")
                      for k in range(bands)]
            px = np.stack([p[:, 0::bpc] for p in planes], -1)
        elif comp == 1:
            status, rows = sgi_rle(data[512:], w, h, bands, bpc)
            if status == 2:
                _fail(name, "an SGI file whose RLE tables or rows run past "
                      "its data (buffer overrun)")
            px = rows.reshape(h, w, bands, bpc)[..., 0]
        else:
            _fail(name, f"an SGI file of compression {comp}, which Pillow "
                  "cannot load")
        px = px[::-1]
        return np.ascontiguousarray(px[..., 0] if bands == 1 else px)

    return Pic("SGI", (w, h), mode, load)


# ---------------------------------------------------------------------------
# PCX and DCX (PcxImagePlugin, DcxImagePlugin; OpenCV reads none)
# ---------------------------------------------------------------------------


def _pcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _pcx_open(data: bytes, name: str, at: int = 0, kind: str = "PCX") -> Pic:
    s = data[at:at + 68]
    if not _pcx_accept(s):
        raise PassOn
    if len(s) < 68:
        raise PassOn
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise PassOn
    version, bits, planes, given = s[1], s[3], s[65], _i16le(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(data) < 769:
            _fail(name, f"a {kind} file shorter than the palette it is read "
                  "for (Pillow's seek before the file's start raises)")
        tail = data[-769:]
        if tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
            if not np.array_equal(pal, ramp):
                mode = rawmode = "P"
                palette = pal
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        _fail(name, f"a {kind} file of an unknown mode (version {version}, "
              f"{bits} bits, {planes} planes), which Pillow refuses")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    row = planes * stride

    def load():
        status, rows = pcx_rle(data[at + 128:], row, h)
        if status == 1:
            _fail(name, f"a truncated {kind} file (its RLE data ends early)")
        if status == 2:
            _fail(name, f"a {kind} file with a run past the end of its row "
                  "(buffer overrun)")
        if rawmode.startswith("P;"):       # 1-bit planes, stride apart
            sp = row // planes
            v = np.zeros((h, w), np.uint8)
            for k in range(planes):
                v |= (_bits(np.ascontiguousarray(
                    rows[:, k * sp:k * sp + (w + 7) // 8]), w) << k).astype(
                        np.uint8)
            return v
        bands = row // w                   # PcxDecode.c's plane shuffle
        st = row // bands if bands else 0
        if st > w:
            rows = rows.copy()
            for i in range(1, bands):
                rows[:, i * w:(i + 1) * w] = rows[:, i * st:i * st + w].copy()
        if rawmode == "1":
            return (_bits(rows, w) * 255).astype(np.uint8)
        if rawmode in ("L", "P"):
            return np.ascontiguousarray(rows[:, :w])
        return np.ascontiguousarray(np.stack(
            [rows[:, k * w:(k + 1) * w] for k in range(3)], -1))

    return Pic(kind, (w, h), mode, load, palette)


DCX_MAGIC = 0x3ADE68B1


def _dcx_open(data: bytes, name: str) -> Pic:
    offsets = []
    for i in range(1024):
        o = data[4 + 4 * i:8 + 4 * i]
        if len(o) < 4:
            raise PassOn                   # struct.error
        off = _i32le(o)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise PassOn                       # EOFError: no first frame
    return _pcx_open(data, name, offsets[0], "DCX")


# ---------------------------------------------------------------------------
# QOI and XBM (QoiImagePlugin, XbmImagePlugin; OpenCV reads neither)
# ---------------------------------------------------------------------------


def _qoi_open(data: bytes, name: str) -> Pic:
    if len(data) < 13:
        raise PassOn
    w, h = _i32be(data, 4), _i32be(data, 8)
    mode = "RGB" if data[12] == 3 else "RGBA"
    bands = len(mode)

    def load():
        status, buf = qoi(data[14:], w * h, bands)
        if status:
            _fail(name, "a truncated QOI file (its op stream ends early)")
        px = np.frombuffer(buf, np.uint8).reshape(h, w, bands)
        return px

    return Pic("QOI", (w, h), mode, load)


XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
# XbmDecode.c's HEX(): a hex digit's value, 0 for any other byte
_HEX = np.array([int(chr(c), 16) if chr(c) in "0123456789abcdefABCDEF"
                 else 0 for c in range(256)], np.uint8)


def _xbm_open(data: bytes, name: str) -> Pic:
    m = XBM_HEAD.match(data[:512])
    if not m:
        raise PassOn
    w, h = int(m.group("width")), int(m.group("height"))

    def load():
        body = np.frombuffer(data, np.uint8, offset=m.end())
        xs = np.flatnonzero(body == ord("x"))
        xs = xs[xs + 3 <= len(body)]
        row = (w + 7) // 8
        need = row * h
        # XbmDecode.c: after each byte the search for the next "x" starts
        # past its two hex digits, so an "x" among them is no byte's
        if (np.diff(xs) < 3).any():
            picks, last = [], -1
            for x in xs:
                if x > last:
                    picks.append(x)
                    last = x + 2
            xs = np.array(picks, np.int64)
        if len(xs) < need:
            _fail(name, "a truncated XBM file (too few hex bytes)")
        p = xs[:need]
        vals = (_HEX[body[p + 1]] << 4) + _HEX[body[p + 2]]
        rows = vals.astype(np.uint8).reshape(h, row)
        return (_bits(rows, w, "little") * 255).astype(np.uint8)

    return Pic("XBM", (w, h), "1", load)


# ---------------------------------------------------------------------------
# DIB (BmpImagePlugin.DibImageFile over image_io's BMP reader)
# ---------------------------------------------------------------------------

DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _dib_open(data: bytes, name: str) -> Pic:
    from . import image_io

    hsize = _i32le(data)
    if hsize == 12:
        if len(data) < 12:
            raise PassOn
        bits, comp, colors, pad = _i16le(data, 10), 0, 0, 3
    else:
        if len(data) < 36:
            raise PassOn
        bits, comp, colors = _i16le(data, 14), _i32le(data, 16), _i32le(
            data, 32)
        pad = 4
    tell = hsize + (12 if comp == 3 and hsize < 52 else 0)
    if bits <= 8:
        tell += pad * (colors or (1 << bits))
    bmp = image_io._Bmp(b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + tell)
                        + data, name)
    return Pic("DIB", bmp.size, bmp.mode,
               lambda: image_io._bmp_pillow_pixels(bmp), bmp.palette)


# ---------------------------------------------------------------------------
# Radiance HDR (grfmt_hdr.cpp, rgbe.cpp; Pillow reads none)
# ---------------------------------------------------------------------------


def _hdr_header(data: bytes):
    """``RGBE_ReadHeader`` as ``HdrDecoder`` calls it -> (width, height,
    offset) or None: lines (``fgets`` of 127 bytes) up to
    ``FORMAT=32-bit_rle_rgbe``, an empty line, then ``-Y h +X w``."""
    pos, n = 0, len(data)

    def fgets():
        nonlocal pos
        if pos >= n:
            return None
        end = data.find(b"\n", pos, pos + 127)
        stop = end + 1 if end >= 0 else min(pos + 127, n)
        line = data[pos:stop]
        pos = stop
        return line

    buf = fgets()
    while True:
        if buf is None:
            return None
        if buf[:1] in (b"", b"\n", b"\0"):
            return None
        if buf == b"FORMAT=32-bit_rle_rgbe\n":
            break
        buf = fgets()
    if fgets() != b"\n":
        return None
    buf = fgets()
    if buf is None:
        return None
    m = re.match(rb"-Y[ \t\n\x0b\x0c\r]*([+-]?\d+)[ \t\n\x0b\x0c\r]*\+X"
                 rb"[ \t\n\x0b\x0c\r]*([+-]?\d+)", buf)
    if not m:
        return None
    return _int32(int(m.group(2))), _int32(int(m.group(1))), pos


def _hdr_opencv(data: bytes, name: str):
    """``HdrDecoder`` as RGB: the floats of ``hdr`` times 255, saturated
    as ``convertTo`` does; None where ``imread`` gives None."""
    head = _hdr_header(data)
    if head is None:
        return None
    w, h, pos = head
    if w <= 0 or h <= 0:
        return None
    _cv_validate(w, h, name, "Radiance HDR")
    status, f = hdr(data[pos:], w, h)
    if status:
        return None
    with np.errstate(over="ignore"):
        return _cv_u8(f * np.float32(255))


# ---------------------------------------------------------------------------
# Dispatch: Pillow's plugin order, OpenCV's signatures
# ---------------------------------------------------------------------------


def _magic(*prefixes):
    return lambda p: p.startswith(prefixes)


def _ico(data: bytes, name: str):
    """ICO: ``IcoFile`` reads an entry of 16 bytes for each of its count;
    none, or one cut short, raises ``IndexError`` / ``struct.error``
    (passed on); else the file is refused as an ICO."""
    n = _i16le(data, 4)
    if n == 0 or len(data) < 6 + 16 * n:
        raise PassOn
    _fail(name, "an ICO file, a format the port does not read yet")


def _cur(data: bytes, name: str):
    """CUR: the largest of its entries names the bitmap's offset, whose
    4-byte header size ``_bitmap`` reads; no entry (``TypeError``), a
    short entry or no header there (``struct.error``) passes the file on,
    else it is refused as a CUR."""
    m = b""
    for i in range(_i16le(data, 4)):
        e = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = e
        elif e[0] > m[0] and e[1] > m[1]:
            m = e
    if len(m) < 16 or len(data[_i32le(m, 12):_i32le(m, 12) + 4]) < 4:
        raise PassOn
    _fail(name, "a CUR file, a format the port does not read yet")


def _refuse(kind: str):
    def opener(data, name):
        _fail(name, f"{kind}, a format the port does not read yet")
    return opener


def _gbr(data: bytes, name: str):
    if len(data) < 20:
        raise PassOn
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if (size < 20 or version not in (1, 2) or w <= 0 or h <= 0
            or depth not in (1, 4) or (version == 2 and data[20:24]
                                       != b"GIMP")):
        raise PassOn
    _fail(name, "a GIMP brush file, a format the port does not read yet")


# ImImagePlugin's header tags and line syntax
IM_TAGS = ("Comment", "Date", "Digitalization equipment",
           "File size (no of images)", "Lut", "Name", "Scale (x,y)",
           "Image size (x*y)", "Image type")
IM_NUMBERS = ("File size (no of images)", "Scale (x,y)", "Image size (x*y)")
IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _im(data: bytes, name: str):
    """IFUNC IM (no magic): ``_open`` reads "key: value" lines of at most
    100 bytes (an LF in the first 100) up to a NUL or Ctrl-Z, and takes
    the file when a known tag is among them and a Ctrl-Z follows; any
    other line passes the file on."""
    if b"\n" not in data[:100]:
        raise PassOn
    pos, tags = 0, 0
    while True:
        c = data[pos:pos + 1]
        pos += len(c)
        if c == b"\r":
            continue
        if not c or c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        stop = len(data) if end < 0 else end + 1
        line, pos = c + data[pos:stop], stop
        if len(line) > 100:
            raise PassOn
        m = IM_SPLIT.match(line[:-2] if line.endswith(b"\r\n") else
                           line[:-1] if line.endswith(b"\n") else line)
        if not m:
            raise PassOn
        key = m.group(1).decode("latin-1")
        if key in IM_NUMBERS:
            for v in m.group(2).replace(b"*", b",").split(b","):
                try:
                    float(v)
                except ValueError:
                    _fail(name, "an IM file with a bad number in its header "
                          "(Pillow raises), a format the port does not read")
        tags += key in IM_TAGS
    if not tags or b"\x1a" not in data[pos - 1:]:
        raise PassOn
    _fail(name, "an IM file, a format the port does not read yet")


IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(data: bytes, name: str):
    """IM Tools (no magic): ``_open`` reads "key value" lines (an LF in
    the first 100 bytes) up to a form feed; the file is taken when they
    give a width, a height and "pixel n8"."""
    if b"\n" not in data[:100]:
        raise PassOn
    w = h = 0
    grey, pos = False, 0
    while pos < len(data):
        if data[pos] == 0x0C:
            break
        end = data.find(b"\n", pos)
        line = data[pos:len(data) if end < 0 else end]
        pos = len(data) if end < 0 else end + 1
        if len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            _fail(name, "an IMT file with a bad size (Pillow raises), a "
                  "format the port does not read")
        grey |= k == b"pixel" and v == b"n8"
    if not (grey and w > 0 and h > 0):
        raise PassOn
    _fail(name, "an IMT file, a format the port does not read yet")


def _spider_int(v: float) -> bool:
    return math.isfinite(v) and v == int(v)


def _spider(data: bytes, name: str):
    """SPIDER (no magic): 27 floats, big-endian then little-endian, whose
    header fields 1, 2, 5, 12, 13, 22 and 23 are whole, form 1 and the
    header length consistent; a 2D image of positive size is taken."""
    if len(data) < 108:
        raise PassOn
    for order in ">", "<":
        h = (99.0,) + struct.unpack(order + "27f", data[:108])
        if (all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23))
                and int(h[5]) in (1, 3, -11, -12, -21, -22)
                and int(h[22]) == int(h[13]) * int(h[23]) and int(h[22])):
            break
    else:
        raise PassOn
    if int(h[5]) != 1:
        raise PassOn
    if not all(math.isfinite(h[i]) for i in (24, 27)):
        _fail(name, "a SPIDER file with a bad stack header (Pillow "
              "raises), a format the port does not read")
    stack, number = int(h[24]), int(h[27])
    if (stack < 0 or number < 0 or (stack > 0 and number > 0)
            or int(h[12]) <= 0 or int(h[2]) <= 0):
        raise PassOn
    _fail(name, "a SPIDER file, a format the port does not read yet")


def _iptc_int(b) -> int:
    """``IptcImagePlugin._i``: the last 4 bytes, big-endian."""
    if not isinstance(b, bytes):
        raise PassOn                           # TypeError
    return _i32be((b"\0\0\0\0" + b)[-4:])


def _iptc(data: bytes, name: str):
    """IPTC/NAA (no magic): ``_open`` reads 5-byte field headers (0x1C, a
    record 1-9 or 240) and their data up to an empty field or (8, 10); it
    takes the file when the layers, size and compression fields name an
    image of positive size. A field longer than 132 or an unknown
    compression makes ``Image.open`` raise."""
    refused = "an IPTC/NAA file, a format the port does not read yet"
    pos, info, tag = 0, {}, None
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            tag = None
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise PassOn
        size = s[3]
        if size > 132:
            _fail(name, refused)
        if size == 128:
            size = 0
        elif size > 128:
            ext = data[pos:pos + size - 128]
            size = _iptc_int(ext)
            pos += len(ext)
        else:
            size = _i16be(s, 3)
        if tag == (8, 10):
            break
        info[tag] = data[pos:pos + size] if size else None
        pos += len(data[pos:pos + size])
    if (3, 60) not in info:
        raise PassOn
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    if not ((layers == 1 and not component)
            or (layers in (3, 4) and component)):
        raise PassOn                           # no mode
    w, h = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    if _iptc_int(info[(3, 120)]) not in (1, 5):
        _fail(name, refused)
    if w <= 0 or h <= 0:
        raise PassOn
    _fail(name, refused)


def _pcd(data: bytes, name: str):
    """Kodak PhotoCD (no magic): ``PCD_`` at 2048, then a header of 1539
    bytes (``IndexError`` short of it)."""
    if data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539:
        _fail(name, "a Kodak PhotoCD file, a format the port does not read "
              "yet")
    raise PassOn


def _avif_accept(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


# Pillow 12.1.0's plugins in the order that Image.open tries them in a
# process that imported PIL.Image alone: (name, accept or None, opener);
# the opener gives a Pic, a kind that image_io reads itself, or raises
# (PassOn to let the next plugin try)
def _claims(kind):
    return lambda data, name: kind


PLUGINS = (
    ("BMP", _magic(b"BM"), _claims("bmp")),
    ("DIB", lambda p: len(p) >= 4 and _i32le(p) in DIB_HEADERS, _dib_open),
    ("GIF", _magic(b"GIF87a", b"GIF89a"), _claims("gif")),
    ("JPEG", _magic(b"\xff\xd8\xff"), _claims("jpeg")),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in
     b"0123456fy", _ppm_open),
    ("PNG", _magic(b"\x89PNG\r\n\x1a\n"), _claims("png")),
    ("AVIF", _avif_accept, _refuse("an AVIF file")),
    ("BLP", _magic(b"BLP1", b"BLP2"), _refuse("a BLP file")),
    ("BUFR", _magic(b"BUFR", b"ZCZC"), _refuse("a BUFR file")),
    ("CUR", _magic(b"\0\0\2\0"), _cur),
    ("PCX", _pcx_accept, _pcx_open),
    ("DCX", lambda p: len(p) >= 4 and _i32le(p) == DCX_MAGIC, _dcx_open),
    ("DDS", _magic(b"DDS "), _refuse("a DDS file")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (
        len(p) >= 4 and _i32le(p) == 0xC6D3D0C5), _refuse("an EPS file")),
    ("FITS", _magic(b"SIMPLE"), _refuse("a FITS file")),
    ("FLI", lambda p: len(p) >= 16 and _i16le(p, 4) in (0xAF11, 0xAF12)
     and _i16le(p, 14) in (0, 3), _refuse("a FLI animation")),
    ("FTEX", _magic(b"FTEX"), _refuse("an FTEX file")),
    ("GBR", lambda p: len(p) >= 8 and _i32be(p) >= 20 and _i32be(p, 4) in
     (1, 2), _gbr),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _refuse("a GRIB file")),
    ("HDF5", _magic(b"\x89HDF\r\n\x1a\n"), _refuse("an HDF5 file")),
    ("JPEG2000", _magic(b"\xffO\xffQ", b"\x00\x00\x00\x0cjP  \r\n\x87\n"),
     _refuse("a JPEG 2000 file")),
    ("ICNS", _magic(b"icns"), _refuse("an ICNS file")),
    ("ICO", _magic(b"\0\0\1\0"), _ico),
    ("IM", None, _im),
    ("IMT", None, _imt),
    ("IPTC", None, _iptc),
    ("MCIDAS", _magic(b"\0\0\0\0\0\0\0\x04"), _refuse("a McIdas file")),
    ("MPEG", _magic(b"\0\0\1\xb3"), _refuse("an MPEG file")),
    ("TIFF", _magic(b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"),
     _claims("tiff")),
    ("MSP", _magic(b"DanM", b"LinS"), _refuse("an MSP file")),
    ("PCD", None, _pcd),
    ("PIXAR", _magic(b"\200\350\000\000"), _refuse("a PIXAR file")),
    ("PSD", _magic(b"8BPS"), _refuse("a Photoshop file")),
    ("QOI", _magic(b"qoif"), _qoi_open),
    ("SGI", lambda p: len(p) >= 2 and _i16be(p) == 474, _sgi_open),
    ("SPIDER", None, _spider),
    ("SUN", lambda p: len(p) >= 4 and _i32be(p) == SUN_MAGIC, _sun_open),
    ("TGA", None, _tga_open),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP",
     _claims("webp")),
    ("WMF", _magic(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"),
     _refuse("a WMF file")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _xbm_open),
    ("XPM", _magic(b"/* XPM */"), _refuse("an XPM file")),
    ("XVTHUMB", _magic(b"P7 332"), _refuse("an XV thumbnail")),
)

# the formats only OpenCV reads, for the "pillow" reader's refusal
OPENCV_ONLY = ((b"P7", "a PAM file"), (b"PF", "a colour PFM file"),
               (b"#?RADIANCE", "a Radiance HDR file"),
               (b"#?RGBE", "a Radiance HDR file"))


def pillow_open(data: bytes, name: str):
    """The plugin Pillow opens ``data`` with, in its order: a ``Pic`` for
    the formats of this module, the kind ("bmp", "gif", "jpeg", "png",
    "tiff", "webp") for those ``image_io`` reads itself, or None where no
    plugin takes it; a plugin that makes ``Image.open`` raise raises
    ``ValueError``."""
    from . import image_io

    prefix = data[:16]
    for _, accept, opener in PLUGINS:
        if accept is not None and not accept(prefix):
            continue
        try:
            got = opener(data, name)
        except (PassOn, IndexError, KeyError, TypeError, struct.error):
            continue
        if isinstance(got, Pic):
            w, h = got.size
            if w <= 0 or h <= 0:
                continue
            image_io._check_size(w, h, name)
        return got
    return None


def refusal(head: bytes) -> str | None:
    """What a file that Pillow identifies as no format is, where OpenCV
    reads it."""
    for magic, kind in OPENCV_ONLY:
        if head.startswith(magic):
            return (f"{kind}, which Pillow does not read (the JAX loader "
                    "cannot train on it; the eval reads it through OpenCV)")
    return None


def opencv_read(data: bytes, name: str):
    """What ``cv2.imread`` gives for the formats of this module whose
    signature it knows, as RGB, or None (no signature, or it fails)."""
    h = data[:10]
    if len(h) >= 3 and h[:1] == b"P" and h[2] in WS:
        if 49 <= h[1] <= 54:
            return _pxm_opencv(data, name)
        if h[1] == 55:
            return _pam_opencv(data, name)
        if h[1] in (70, 102):
            return _pfm_opencv(data, name)
    if len(h) >= 4 and _i32be(h) == SUN_MAGIC:
        return _sun_opencv(data, name)
    if h.startswith((b"#?RGBE", b"#?RADIANCE")):
        return _hdr_opencv(data, name)
    return None


def pic_rgb(pic: Pic) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of an opened file."""
    from . import image_io

    return image_io._mode_rgb(pic.mode, pic.load(), pic.palette)


def pic_raw(pic: Pic) -> np.ndarray:
    """``np.asarray`` of an opened file."""
    from . import image_io

    return image_io._mode_raw(pic.mode, pic.load())
