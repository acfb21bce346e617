"""Writes the raster fixtures under
``sam2_video_tpu_torch/data/fixtures/raster`` (TIFF, BMP and GIF frames)
from seeds, and their digests:

- ``coverage/``: small files (at most 40 x 40), one per kind that the
  port's readers decode: TIFF strips and tiles, planar configurations 1 and
  2, BigTIFF, both byte orders, no compression, LZW, Adobe and old
  deflate, PackBits and JPEG, predictors 2 (8, 16 and 32 bits) and 3,
  every photometric interpretation and sample kind that differs between
  the two readers (16-bit grey and RGB, unassociated alpha, float and
  32-bit integer grey, orientations 1-8, several pages); BMP of 1, 4, 8,
  16, 24 and 32 bits, OS/2 and V3-V5 headers, bottom-up and top-down,
  BI_RGB, RLE4, RLE8, BITFIELDS and ALPHABITFIELDS, short palettes; GIF
  plain, interlaced, grey, with local colour tables, a transparent index
  and an image smaller than its screen;
- ``video/``: a COCO-RLE video dataset of 2 videos x 8 frames of 240x320
  (the JPEG fixtures' frames and annotations) as 8-bit RGB TIFF with LZW
  and predictor 2, read with ``image_root``;
- ``timing/``: two 240x320 frames each of LZW TIFF, PackBits TIFF, 24-bit
  BMP and GIF;
- ``digests.json``: for every file its size and the sha256 of Pillow's
  ``convert("RGB")`` (``sha256``; null where Pillow cannot load it), of
  the JAX eval's reader (OpenCV's ``imread``, or Pillow where that returns
  None: ``opencv_sha256``, with ``opencv_none`` saying which) and of
  ``np.asarray(Image.open(f))`` (``raw_*``).

Pillow writes what it can; the encoders below write the rest (BMP
headers, bit fields and RLE; TIFF tiles, planes, BigTIFF, predictors,
byte orders and orientations). ``tests/test_torch_port_raster.py``
regenerates the files and asks for the same bytes. To rewrite them:
``python tests/raster_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RASTER = REPO / "sam2_video_tpu_torch" / "data" / "fixtures" / "raster"
JPEG_VIDEO = RASTER.parent / "jpeg" / "video"
TIMING_HW = (240, 320)


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A gradient with soft waves, flat blocks and a little noise, uint8
    [h, w, 3]."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / max(w - 1, 1) * 220 + 20,
                    yy / max(h - 1, 1) * 200 + 30,
                    128 + 90 * np.sin(xx / 5.0 + yy / 7.0)], -1)
    for _ in range(3):
        y0, x0 = g.integers(0, max(h, 1)), g.integers(0, max(w, 1))
        img[y0:y0 + h // 4 + 1, x0:x0 + w // 4 + 1] = g.uniform(0, 255, 3)
    img += g.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Encoders: LZW (TIFF: MSB-first, early change; GIF: LSB-first), PackBits
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self, msb: bool):
        self.msb, self.acc, self.n, self.out = msb, 0, 0, bytearray()

    def put(self, code: int, width: int):
        if self.msb:
            self.acc = (self.acc << width) | code
            self.n += width
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 0xFF)
        else:
            self.acc |= code << self.n
            self.n += width
            while self.n >= 8:
                self.out.append(self.acc & 0xFF)
                self.acc >>= 8
                self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.out.append(((self.acc << (8 - self.n)) if self.msb
                             else self.acc) & 0xFF)
            self.acc = self.n = 0
        return bytes(self.out)


def lzw_encode(data: bytes, gif_min_bits: int | None = None) -> bytes:
    """TIFF LZW (``gif_min_bits`` None: 8-bit symbols, codes MSB-first,
    the code width grown one code early, a Clear code first and whenever
    the table reaches 4094) or GIF LZW (LSB-first, ``gif_min_bits``-bit
    symbols, widths grown when the table reaches 2^width, Clear at 4096)."""
    tiff = gif_min_bits is None
    m = 8 if tiff else gif_min_bits
    clear, end = 1 << m, (1 << m) + 1
    w = _BitWriter(msb=tiff)
    limit = 4094 if tiff else 4096

    def reset():
        return {bytes([i]): i for i in range(1 << m)}, clear + 2, m + 1

    def grow(width: int, seen: int) -> int:
        """The decoder's width once it has ``seen`` table entries: TIFF's
        grows at 2^width - 1 (its early change), GIF's at 2^width."""
        return width + 1 if seen + tiff >= (1 << width) and width < 12 \
            else width

    table, nxt, width = reset()
    w.put(clear, width)
    cur = b""
    for b in data:
        cand = cur + bytes([b])
        if cand in table:
            cur = cand
            continue
        w.put(table[cur], width)
        table[cand] = nxt
        nxt += 1
        if nxt >= limit:
            w.put(clear, width)
            table, nxt, width = reset()
        else:
            # the decoder adds each entry one code later
            width = grow(width, nxt - 1)
        cur = bytes([b])
    if cur:
        w.put(table[cur], width)
        width = grow(width, nxt)
    w.put(end, width)
    return w.flush()


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (257 - n, byte), literals of
    up to 128 bytes as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

# TIFF field type -> struct format of each value given: 3 SHORT, 4 LONG,
# 5 RATIONAL (numerators and denominators in turn), 7 UNDEFINED, 16 LONG8
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}


def _pack_bits(vals: np.ndarray, bits: int) -> bytes:
    """Rows of unsigned values [rows, n] at ``bits`` each, MSB first, each
    row padded to a byte."""
    rows, n = vals.shape
    v = vals.astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    b = ((v[..., None] >> shifts) & 1).astype(np.uint8).reshape(rows, -1)
    pad = (-b.shape[1]) % 8
    b = np.concatenate([b, np.zeros((rows, pad), np.uint8)], 1)
    return np.packbits(b, axis=1).tobytes()


def sample_rows(vals: np.ndarray, bits: int, fmt: int, order: str,
                predictor: int = 1, stride: int = 1) -> bytes:
    """Sample rows [rows, n] (n samples a row, ``stride`` of them a
    pixel) as TIFF bytes: ``bits`` 1-32, ``fmt`` 1 unsigned, 2 signed, 3
    IEEE float, byte order ``order`` ("<" or ">"), horizontal predictor 2
    or floating-point predictor 3 applied (libtiff's ``horDiff*`` and
    ``fpDiff``)."""
    rows, n = vals.shape
    if fmt == 3:
        f = np.asarray(vals, np.float32)
        if predictor == 3:
            be = f.astype(">f4").view(np.uint8).reshape(rows, n, 4)
            planes = be.transpose(0, 2, 1).reshape(rows, 4 * n).astype(
                np.int32)
            diff = planes.copy()
            diff[:, stride:] = planes[:, stride:] - planes[:, :-stride]
            return (diff & 0xFF).astype(np.uint8).tobytes()
        return f.astype(order + "f4").tobytes()
    v = np.asarray(vals, np.int64) & ((1 << bits) - 1)
    if predictor == 2:
        d = v.copy()
        d[:, stride:] = v[:, stride:] - v[:, :-stride]
        v = d & ((1 << bits) - 1)
    if bits in (8, 16, 32):
        return v.astype(f"{order}u{bits // 8}").tobytes()
    return _pack_bits(v, bits)


def _compress(chunk: bytes, compression: int) -> bytes:
    if compression == 1:
        return chunk
    if compression == 5:
        return lzw_encode(chunk)
    if compression in (8, 32946):
        return zlib.compress(chunk, 6)
    if compression == 32773:
        return packbits(chunk)
    raise ValueError(compression)


def _reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def tiff_ifd(img: np.ndarray, *, photometric: int, bps, fmt: int = 1,
             extra=(), order: str = "<", compression: int = 1,
             predictor: int = 1, planar: int = 1, fill: int = 1, tile=None,
             rows_per_strip=None, orientation=None, colormap=None,
             spp=None, tags=None) -> tuple[list, list]:
    """One image's (tags, chunks): ``img`` [H, W, samples] (values at
    ``bps`` bits, or floats), cut into strips of ``rows_per_strip`` rows
    (all by default) or tiles of ``tile`` = (width, height), each
    compressed. ``bps`` an int or one per sample; ``tags`` adds or
    overrides entries {tag: (type, values)}."""
    H, W, S = img.shape
    bps_t = tuple(bps) if isinstance(bps, (tuple, list)) else (bps,) * S
    bits = bps_t[0]
    planes = [img] if planar == 1 else [img[..., s:s + 1] for s in range(S)]
    chunks = []
    for plane in planes:
        ps = plane.shape[2]
        if tile is None:
            rps = rows_per_strip or H
            for y0 in range(0, H, rps):
                part = plane[y0:y0 + rps].reshape(-1, W * ps)
                chunks.append(sample_rows(part, bits, fmt, order, predictor,
                                          ps))
        else:
            tw, th = tile
            for y0 in range(0, H, th):
                for x0 in range(0, W, tw):
                    part = np.zeros((th, tw, ps), plane.dtype)
                    blk = plane[y0:y0 + th, x0:x0 + tw]
                    part[:blk.shape[0], :blk.shape[1]] = blk
                    chunks.append(sample_rows(part.reshape(th, tw * ps),
                                              bits, fmt, order, predictor,
                                              ps))
    chunks = [_compress(c, compression) for c in chunks]
    if fill == 2:
        chunks = [_reverse_bits(c) for c in chunks]
    t = {256: (4, [W]), 257: (4, [H]), 258: (3, list(bps_t)),
         259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [spp or S])}
    if fill != 1:
        t[266] = (3, [fill])
    if orientation is not None:
        t[274] = (3, [orientation])
    if planar != 1:
        t[284] = (3, [planar])
    if predictor != 1:
        t[317] = (3, [predictor])
    if colormap is not None:
        t[320] = (3, list(colormap))
    if extra:
        t[338] = (3, list(extra))
    if fmt != 1:
        t[339] = (3, [fmt] * S)
    if tile is None:
        t[278] = (4, [rows_per_strip or H])
        t[273], t[279] = "offsets", (4, [len(c) for c in chunks])
    else:
        t[322], t[323] = (3, [tile[0]]), (3, [tile[1]])
        t[324], t[325] = "offsets", (4, [len(c) for c in chunks])
    t.update(tags or {})
    return t, chunks


def tiff_file(pages, order: str = "<", bigtiff: bool = False) -> bytes:
    """Pages [(tags, chunks)] as one file: the header, every page's chunks,
    then the IFDs chained in order (values that do not fit an entry
    after each IFD)."""
    ent, off_t = ("HHQQ", 20) if bigtiff else ("HHII", 12)
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, 0) if bigtiff
        else struct.pack(order + "HI", 42, 0))
    out = bytearray(head)
    placed = []
    for tags, chunks in pages:
        offs = []
        for c in chunks:
            offs.append(len(out))
            out += c
            if len(out) % 2:
                out += b"\0"
        placed.append((tags, offs))
    next_pos = 8 if bigtiff else 4
    inline = 8 if bigtiff else 4
    for tags, offs in placed:
        entries = {}
        for tag, spec in tags.items():
            if spec == "offsets":
                spec = (16 if bigtiff else 4, offs)
            entries[tag] = spec
        n = len(entries)
        ifd_pos = len(out)
        struct.pack_into(order + ("Q" if bigtiff else "I"), out, next_pos,
                         ifd_pos)
        count_fmt = "Q" if bigtiff else "H"
        body = bytearray(struct.pack(order + count_fmt, n))
        table_end = ifd_pos + len(body) + n * off_t + inline
        extra = bytearray()
        for tag in sorted(entries):
            typ, vals = entries[tag]
            if typ == 4 and bigtiff and tag in (273, 279, 324, 325):
                typ = 16
            if isinstance(vals, (bytes, bytearray)):
                payload, count = bytes(vals), len(vals)
            else:
                payload = struct.pack(order + _TYPE_FMT[typ] * len(vals),
                                      *vals)
                count = len(vals) // 2 if typ == 5 else len(vals)
            if len(payload) <= inline:
                value = payload + bytes(inline - len(payload))
            else:
                pos = table_end + len(extra)
                extra += payload
                if len(extra) % 2:
                    extra += b"\0"
                value = struct.pack(order + ("Q" if bigtiff else "I"), pos)
            body += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag,
                                typ, count) + value
        next_pos = ifd_pos + len(body)
        body += bytes(inline)
        out += body + extra
    return bytes(out)


def tiff(img, order: str = "<", bigtiff: bool = False, **kw) -> bytes:
    """One page; ``kw`` as ``tiff_ifd``."""
    return tiff_file([tiff_ifd(img, order=order, **kw)], order, bigtiff)


def digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()
                          ).hexdigest()


def digest_raw(a: np.ndarray) -> str:
    """sha256 of an array's bytes in little-endian order."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()
                          ).hexdigest()


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp(pixels: np.ndarray, bits: int, *, header: int = 40,
        compression: int = 0, palette=None, colors: int | None = None,
        masks=None, top_down: bool = False, rle: bytes | None = None,
        gap: int = 0) -> bytes:
    """A BMP: ``pixels`` [H, W] palette indices (1, 4, 8 bits) or
    [H, W] packed values (16, 32 bits) or [H, W, 3] BGR bytes (24 bits),
    rows top first; ``header`` 12 (OS/2 BITMAPCOREHEADER), 40, 52, 56, 108
    or 124; ``compression`` 0 BI_RGB, 1 RLE8, 2 RLE4 (``rle``: the coded
    bytes), 3 BITFIELDS, 6 ALPHABITFIELDS (``masks``: 3 or 4, in the
    header from 52 bytes on, after a 40-byte one); ``palette`` [n, 3] RGB
    (``colors``: the count the header gives, 0 for 2^bits); ``top_down``:
    a negative height; ``gap`` bytes between the palette and the pixels."""
    H, W = pixels.shape[:2]
    if rle is not None:
        body = rle
    else:
        stride = ((W * bits + 31) >> 3) & ~3
        rows = []
        for y in range(H):
            p = pixels[y]
            if bits == 24:
                raw = np.ascontiguousarray(p, np.uint8).tobytes()
            elif bits in (16, 32):
                raw = np.asarray(p, f"<u{bits // 8}").tobytes()
            else:
                raw = _pack_bits(np.asarray(p)[None], bits)
            rows.append(raw + bytes(stride - len(raw)))
        body = b"".join(rows if top_down else rows[::-1])
    pal = b""
    if palette is not None:
        pal_rgb = np.asarray(palette, np.uint8)
        bgr = pal_rgb[:, ::-1]
        if header == 12:
            pal = bgr.tobytes()
        else:
            pal = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)],
                                 1).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, W, H, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, W, -H if top_down else H,
                           1, bits, compression, len(body), 2835, 2835,
                           len(palette) if colors is None and palette is not
                           None else (colors or 0), 0)
        m = list(masks or [])
        if header >= 52:
            m = (m + [0, 0, 0, 0])[:4 if header >= 56 else 3]
            info += struct.pack(f"<{len(m)}I", *m)
            masks = None
        info += bytes(header - len(info))
    extra = struct.pack(f"<{len(masks)}I", *masks) if masks else b""
    offset = 14 + len(info) + len(extra) + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + extra + pal + bytes(gap) + body)


def rle_encode(indices: np.ndarray, bits: int) -> bytes:
    """RLE8 / RLE4 of [H, W] palette indices, bottom row first: runs of
    equal pixels (pairs alternating in RLE4) as encoded runs, the rest in
    absolute runs of at least 3 pixels, an end of line after each row and
    an end of bitmap."""
    out = bytearray()
    H, W = indices.shape
    for y in range(H - 1, -1, -1):
        row = [int(v) for v in indices[y]]
        x = 0
        while x < W:
            n = 1
            while (x + n < W and n < 255
                   and row[x + n] == row[x + (n % 2 if bits == 4 else 0)]):
                n += 1
            if n >= 3 or W - x < 3:
                out += bytes([n, row[x] if bits == 8 else
                              (row[x] << 4) | (row[x + 1] if n > 1 else 0)])
                x += n
                continue
            n = 3
            while x + n < W and n < 255 and not (
                    x + n + 2 < W and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            if bits == 8:
                data = bytes(row[x:x + n])
            else:
                vals = row[x:x + n] + [0]
                data = bytes((vals[i] << 4) | vals[i + 1]
                             for i in range(0, n, 2))
            out += bytes([0, n]) + data + bytes(len(data) % 2)
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _gif_interlace(indices: np.ndarray) -> np.ndarray:
    """Rows in GIF interlaced order: every 8th from 0, every 8th from 4,
    every 4th from 2, every 2nd from 1."""
    return np.concatenate([indices[0::8], indices[4::8], indices[2::4],
                           indices[1::2]])


def gif(indices: np.ndarray, *, palette=None, local=None, screen=None,
        at=(0, 0), interlace: bool = False, transparent: int | None = None,
        background: int = 0, min_bits: int | None = None,
        version: bytes = b"GIF89a", frames=()) -> bytes:
    """A GIF whose first image is ``indices`` [h, w] placed at ``at`` =
    (x, y) on a ``screen`` = (width, height) (the image's size by
    default): ``palette`` the global colour table [n, 3] (n a power of 2),
    ``local`` a local one, ``transparent`` the index a graphic control
    extension names, ``min_bits`` the LZW minimum code size; ``frames``
    more images [h, w] after it."""
    h, w = indices.shape
    W, H = screen or (w, h)
    out = bytearray(version + struct.pack("<HH", W, H))
    if palette is not None:
        size = len(palette).bit_length() - 1
        out += bytes([0x80 | 0x70 | (size - 1), background, 0])
        out += np.asarray(palette, np.uint8).tobytes()
    else:
        out += bytes([0x70, background, 0])
    for k, img in enumerate((indices, *frames)):
        ih, iw = img.shape
        if transparent is not None and k == 0:
            out += b"!\xf9\x04" + bytes([1, 0, 0, transparent, 0])
        x, y = at if k == 0 else (0, 0)
        flags = 0x40 if interlace and k == 0 else 0
        lp = local if k == 0 else None
        if lp is not None:
            flags |= 0x80 | (len(lp).bit_length() - 2)
        out += b"," + struct.pack("<HHHHB", x, y, iw, ih, flags)
        if lp is not None:
            out += np.asarray(lp, np.uint8).tobytes()
        bits = min_bits or max(2, int(img.max(initial=0)).bit_length())
        rows = _gif_interlace(img) if flags & 0x40 else img
        data = lzw_encode(np.asarray(rows, np.uint8).tobytes(), bits)
        out += bytes([bits])
        for i in range(0, len(data), 255):
            chunk = data[i:i + 255]
            out += bytes([len(chunk)]) + chunk
        out += b"\0"
    return bytes(out + b";")


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def _pillow(img, fmt: str, **kw) -> bytes:
    from PIL import Image

    im = img if isinstance(img, Image.Image) else Image.fromarray(img)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _jpeg_tiff(img: np.ndarray, photometric: int) -> bytes:
    """A JPEG-compressed TIFF by hand: a Pillow JPEG cut into the
    JPEGTables tag (its DQT and DHT segments) and one abbreviated strip
    (SOF, SOS and the scan). Photometric 6: YCbCr 4:2:0, which libjpeg
    converts; 2: the 4:4:4 file's samples taken as RGB as stored; 1:
    grey."""
    data = _pillow(img, "JPEG", quality=85,
                   subsampling=2 if photometric == 6 else 0)
    segs, pos = [], 2
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            segs.append((marker, data[pos:]))
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        segs.append((marker, data[pos:pos + 2 + n]))
        pos += 2 + n
    tables = b"\xff\xd8" + b"".join(s for m, s in segs
                                    if m in (0xDB, 0xC4)) + b"\xff\xd9"
    strip = b"\xff\xd8" + b"".join(s for m, s in segs
                                   if m in (0xC0, 0xDA))
    H, W = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [8] * spp),
            259: (3, [7]), 262: (3, [photometric]), 277: (3, [spp]),
            278: (4, [H]), 273: "offsets", 279: (4, [len(strip)]),
            347: (7, tables)}
    if photometric == 6:
        tags[530] = (3, [2, 2])
    return tiff_file([(tags, [strip])])


def ycbcr_tiff(rgb: np.ndarray, h: int, v: int, compression: int = 1,
               rows_per_strip: int | None = None, **tags) -> bytes:
    """RGB as a YCbCr TIFF (photometric 6) in h x v subsampling blocks of
    h v Y samples, then Cb and Cr (JFIF's conversion, chroma averaged over
    the block, edge pixels repeated into partial blocks); ``tags``:
    orientation."""
    H, W, _ = rgb.shape
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = 128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2]
    cr = 128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2]
    bw, bh = -(-W // h), -(-H // v)
    pad = [(0, bh * v - H), (0, bw * h - W)]
    planes = [np.pad(c, pad, mode="edge").reshape(bh, v, bw, h)
              for c in (y, cb, cr)]
    ys = planes[0].transpose(0, 2, 1, 3).reshape(bh, bw, h * v)
    blocks = np.concatenate([ys, planes[1].mean((1, 3))[..., None],
                             planes[2].mean((1, 3))[..., None]], -1)
    blocks = np.clip(np.round(blocks), 0, 255).astype(np.uint8)
    rps = rows_per_strip or H
    strips = [_compress(blocks[y0 // v:-(-(y0 + rps) // v)].tobytes(),
                        compression) for y0 in range(0, H, rps)]
    t = {256: (4, [W]), 257: (4, [H]), 258: (3, [8, 8, 8]),
         259: (3, [compression]), 262: (3, [6]), 277: (3, [3]),
         278: (4, [rps]), 273: "offsets", 279: (4, list(map(len, strips))),
         530: (3, [h, v])}
    if "orientation" in tags:
        t[274] = (3, [tags["orientation"]])
    return tiff_file([(t, strips)])


def tiff_coverage() -> dict:
    from PIL import Image

    g = np.random.default_rng(18)
    rgb = scene(29, 37, 1)
    grey = rgb[..., 1]
    out = {
        "tiff_rgb_none.tif": tiff(rgb, photometric=2, bps=8,
                                  rows_per_strip=7),
        "tiff_rgb_lzw.tif": tiff(rgb, photometric=2, bps=8, compression=5),
        "tiff_rgb_lzw_pred2.tif": tiff(rgb, photometric=2, bps=8,
                                       compression=5, predictor=2,
                                       rows_per_strip=8),
        "tiff_rgb_adobe_deflate.tif": tiff(rgb, photometric=2, bps=8,
                                           compression=8),
        "tiff_rgb_deflate_old.tif": tiff(rgb, photometric=2, bps=8,
                                         compression=32946, predictor=2),
        "tiff_rgb_packbits.tif": tiff(rgb, photometric=2, bps=8,
                                      compression=32773, rows_per_strip=5),
        "tiff_rgb_jpeg.tif": _jpeg_tiff(rgb, 2),
        "tiff_ycbcr_jpeg.tif": _jpeg_tiff(scene(32, 40, 2), 6),
        "tiff_ycbcr_lzw.tif": ycbcr_tiff(scene(29, 37, 8), 2, 2,
                                         compression=5, rows_per_strip=8),
        "tiff_ycbcr_none.tif": ycbcr_tiff(scene(29, 37, 8), 2, 1),
        "tiff_grey_jpeg.tif": _jpeg_tiff(grey, 1),
        "tiff_palette8.tif": _pillow(Image.fromarray(rgb).quantize(64),
                                     "TIFF"),
        "tiff_palette4.tif": tiff(
            g.integers(0, 16, (29, 37, 1)), photometric=3, bps=4,
            colormap=list(g.integers(0, 65536, 48)), compression=5),
        "tiff_bilevel.tif": _pillow(Image.fromarray(grey).convert("1"),
                                    "TIFF"),
        "tiff_bilevel_fillorder2.tif": tiff(
            (grey[..., None] > 128).astype(np.int64), photometric=0, bps=1,
            fill=2),
        "tiff_miniswhite.tif": tiff(grey[..., None], photometric=0, bps=8,
                                    compression=32773),
        "tiff_cmyk.tif": tiff(g.integers(0, 256, (29, 37, 4)),
                              photometric=5, bps=8, compression=5),
        "tiff_cmyk_pillow.tif": _pillow(Image.fromarray(rgb).convert("CMYK"),
                                        "TIFF"),
        "tiff_grey16.tif": tiff(_grey16(29, 37), photometric=1, bps=16),
        "tiff_grey16_be_lzw_pred2.tif": tiff(
            _grey16(29, 37), order=">", photometric=1, bps=16,
            compression=5, predictor=2, rows_per_strip=10),
        "tiff_rgb16.tif": tiff(rgb.astype(np.int64) * 257
                               + g.integers(0, 257, rgb.shape),
                               photometric=2, bps=16, compression=8),
        "tiff_rgba_unassoc.tif": _pillow(np.concatenate(
            [rgb, g.integers(0, 256, (29, 37, 1), np.uint8)], -1), "TIFF"),
        "tiff_rgba_assoc.tif": tiff(_premultiplied(rgb, g), photometric=2,
                                    bps=8, extra=(1,), compression=5),
        "tiff_la.tif": tiff(np.stack([grey, 255 - grey], -1), photometric=1,
                            bps=8, extra=(2,)),
        "tiff_float32.tif": _pillow(Image.fromarray(
            grey.astype(np.float32) * 1.13 - 10.37, "F"), "TIFF"),
        "tiff_float32_lzw_pred3.tif": tiff(
            (grey.astype(np.float32) * 1.13 - 10.37)[..., None],
            photometric=1, bps=32, fmt=3, compression=5, predictor=3),
        "tiff_int32_deflate_pred2.tif": tiff(
            (grey.astype(np.int64) * 3 - 100)[..., None], photometric=1,
            bps=32, fmt=2, compression=8, predictor=2),
        "tiff_multipage.tif": tiff_file([
            tiff_ifd(rgb, photometric=2, bps=8),
            tiff_ifd(rgb[::-1].copy(), photometric=2, bps=8)]),
        "tiff_tiled_lzw.tif": tiff(scene(40, 40, 3), photometric=2, bps=8,
                                   compression=5, predictor=2,
                                   tile=(16, 16)),
        "tiff_tiled_orientation2.tif": tiff(scene(40, 40, 4),
                                            photometric=2, bps=8,
                                            tile=(16, 16), orientation=2),
        "tiff_planar_rgb.tif": tiff(rgb, photometric=2, bps=8, planar=2,
                                    rows_per_strip=10),
        "tiff_planar_rgb_lzw.tif": tiff(rgb, photometric=2, bps=8, planar=2,
                                        compression=5, predictor=2),
        "tiff_bigtiff_deflate.tif": tiff(rgb, bigtiff=True, photometric=2,
                                         bps=8, compression=8,
                                         rows_per_strip=10),
        "tiff_be_rgb_lzw.tif": tiff(rgb, order=">", photometric=2, bps=8,
                                    compression=5, rows_per_strip=9),
    }
    for o in range(1, 9):
        out[f"tiff_orientation{o}.tif"] = tiff(scene(20, 36, 5),
                                               photometric=2, bps=8,
                                               orientation=o)
    return out


def _grey16(h: int, w: int) -> np.ndarray:
    """16-bit grey whose first samples are 60585, 61083, 12101 and 7532."""
    v = (np.arange(h * w, dtype=np.int64) * 2654435761 % 65536).reshape(
        h, w, 1)
    v.reshape(-1)[:4] = (60585, 61083, 12101, 7532)
    return v


def _premultiplied(rgb: np.ndarray, g) -> np.ndarray:
    a = g.integers(0, 256, rgb.shape[:2] + (1,))
    return np.concatenate([rgb.astype(np.int64) * a // 255, a], -1)


def bmp_coverage() -> dict:
    from PIL import Image

    g = np.random.default_rng(19)
    H, W = 23, 31
    rgb = scene(H, W, 6)
    idx4, idx8 = g.integers(0, 16, (H, W)), g.integers(0, 256, (H, W))
    pal16, pal256 = g.integers(0, 256, (16, 3)), g.integers(0, 256, (256, 3))
    idx_rle = np.repeat(np.repeat(g.integers(0, 16, (H, 8)), 4, 1), 1, 0)[
        :, :W]
    v16 = g.integers(0, 1 << 16, (H, W))
    v32 = g.integers(0, 1 << 32, (H, W), dtype=np.uint64)
    grey_ramp = np.repeat(np.arange(16)[:, None], 3, 1)
    return {
        "bmp1.bmp": _pillow(Image.fromarray(rgb[..., 0]).convert("1"),
                            "BMP"),
        "bmp1_colour.bmp": bmp(g.integers(0, 2, (H, W)), 1,
                               palette=pal16[:2]),
        "bmp4.bmp": bmp(idx4, 4, palette=pal16),
        "bmp4_short_palette.bmp": bmp(idx4, 4, palette=pal16[:9]),
        "bmp4_grey_ramp.bmp": bmp(idx4, 4, palette=grey_ramp),
        "bmp4_os2.bmp": bmp(idx4, 4, palette=pal16, header=12),
        "bmp8.bmp": _pillow(Image.fromarray(rgb).quantize(200), "BMP"),
        "bmp8_grey.bmp": _pillow(rgb[..., 2], "BMP"),
        "bmp8_short_palette_v3.bmp": bmp(idx8 % 200, 8,
                                         palette=pal256[:150], header=56),
        "bmp16_555.bmp": bmp(v16, 16),
        "bmp16_565_bitfields.bmp": bmp(v16, 16, compression=3,
                                       masks=[0xF800, 0x7E0, 0x1F]),
        "bmp16_565_bitfields_v5.bmp": bmp(v16, 16, compression=3, header=124,
                                          masks=[0xF800, 0x7E0, 0x1F]),
        "bmp24.bmp": _pillow(rgb, "BMP"),
        "bmp24_os2.bmp": bmp(rgb[..., ::-1], 24, header=12),
        "bmp24_top_down_v4.bmp": bmp(rgb[..., ::-1], 24, header=108,
                                     top_down=True),
        "bmp32.bmp": bmp(v32, 32),
        "bmp32_bitfields_rgba_v5.bmp": bmp(
            v32, 32, compression=3, header=124,
            masks=[0xFF, 0xFF00, 0xFF0000, 0xFF000000]),
        "bmp32_bitfields_xbgr_v4.bmp": bmp(
            v32, 32, compression=3, header=108,
            masks=[0xFF000000, 0xFF0000, 0xFF00, 0]),
        "bmp_rle8.bmp": bmp(idx_rle, 8, palette=pal256, compression=1,
                            rle=rle_encode(idx_rle, 8)),
        "bmp_rle4.bmp": bmp(idx_rle, 4, palette=pal16, compression=2,
                            rle=rle_encode(idx_rle, 4)),
        "bmp_rle8_eol.bmp": bmp(idx_rle, 8, palette=pal256, compression=1,
                                rle=_rle_eol(idx_rle)),
        "bmp_rle8_delta.bmp": bmp(idx_rle, 8, palette=pal256, compression=1,
                                  rle=_rle_delta(idx_rle)),
        "bmp_rle4_odd_absolute.bmp": bmp(idx_rle, 4, palette=pal16,
                                         compression=2,
                                         rle=_rle4_odd(idx_rle)),
    }


def _rle_eol(idx: np.ndarray) -> bytes:
    """RLE8 rows of which every third stops half way with an end of line
    (both readers leave the rest at palette index 0)."""
    out = bytearray()
    H, W = idx.shape
    for y in range(H - 1, -1, -1):
        n = W // 2 if y % 3 == 0 else W
        for x in range(n):
            out += bytes([1, int(idx[y, x])])
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle_delta(idx: np.ndarray) -> bytes:
    """RLE8 rows with a delta (3, 0) after the first 5 pixels of every
    fourth row, then the rest of the row: OpenCV skips 3 pixels; Pillow
    reads the next two bytes as the delta's (dx, dy)."""
    out = bytearray()
    H, W = idx.shape
    for y in range(H - 1, -1, -1):
        x = 0
        while x < W:
            if y % 4 == 0 and x == 5:
                out += b"\0\2\3\0"
                x += 3
                continue
            out += bytes([1, int(idx[y, x])])
            x += 1
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4_odd(idx: np.ndarray) -> bytes:
    """RLE4 rows as absolute runs of 5 pixels (3 bytes, padded to 4):
    Pillow reads 5 // 2 bytes of each and OpenCV 3."""
    out = bytearray()
    H, W = idx.shape
    for y in range(H - 1, -1, -1):
        x = 0
        while x + 5 <= W:
            v = [int(t) for t in idx[y, x:x + 5]] + [0]
            out += bytes([0, 5]) + bytes((v[i] << 4) | v[i + 1]
                                         for i in range(0, 6, 2)) + b"\0"
            x += 5
        while x < W:
            out += bytes([1, int(idx[y, x]) << 4])
            x += 1
        out += b"\0\0"
    return bytes(out + b"\0\1")


def gif_coverage() -> dict:
    from PIL import Image

    g = np.random.default_rng(20)
    rgb = scene(27, 35, 7)
    q = Image.fromarray(rgb).quantize(100)
    idx = g.integers(0, 16, (19, 23))
    pal = g.integers(0, 256, (16, 3))
    return {
        "gif.gif": _pillow(q, "GIF"),
        "gif_interlaced.gif": _pillow(q, "GIF", interlace=True),
        "gif_grey.gif": _pillow(rgb[..., 1], "GIF"),
        "gif87a_local_table.gif": gif(idx, palette=None, local=pal,
                                      version=b"GIF87a"),
        "gif_transparent.gif": gif(idx, palette=pal, transparent=3,
                                   background=5),
        "gif_small_image.gif": gif(idx, palette=pal, screen=(31, 24),
                                   at=(5, 3), background=9),
        "gif_small_image_transparent.gif": gif(
            idx, palette=pal, screen=(31, 24), at=(5, 3), background=9,
            transparent=2, interlace=True),
        "gif_two_frames.gif": gif(idx, palette=pal,
                                  frames=(idx[::-1].copy(),)),
        "gif_index_past_table.gif": gif(g.integers(0, 8, (11, 13)),
                                        palette=pal[:4], min_bits=3),
    }


def _video_frames() -> tuple[dict, dict]:
    """The JPEG fixtures' video (Pillow's decode): {file name: RGB} and its
    annotations."""
    from PIL import Image

    ann = json.loads((JPEG_VIDEO / "annotations.json").read_text())
    return {im["file_name"]: np.asarray(Image.open(
        JPEG_VIDEO / "images" / im["file_name"]).convert("RGB"))
        for im in ann["images"]}, ann


def video_dataset(root: Path) -> None:
    """The JPEG fixtures' video dataset (2 x 8 frames of 240x320, the same
    annotations) with each frame as an 8-bit RGB TIFF, LZW with the
    horizontal predictor in strips of 16 rows."""
    frames, ann = _video_frames()
    (root / "images").mkdir(parents=True, exist_ok=True)
    for im in ann["images"]:
        rgb = frames[im["file_name"]]
        im["file_name"] = im["file_name"].replace(".jpg", ".tif")
        (root / "images" / im["file_name"]).write_bytes(tiff(
            rgb, photometric=2, bps=8, compression=5, predictor=2,
            rows_per_strip=16))
    (root / "annotations.json").write_text(json.dumps(ann))


def timing_frames() -> dict:
    """Two 240x320 video frames each as LZW and PackBits TIFF (strips of 16
    rows), 24-bit BMP and GIF (Pillow's writers; the GIF of 256 colours).
    TIFF is written here, not by Pillow: libtiff's output through Pillow
    differs from run to run in bytes no reader looks at."""
    from PIL import Image

    frames, _ = _video_frames()
    out = {}
    for i, name in enumerate(sorted(frames)[::8]):
        rgb = frames[name]
        out[f"lzw_{i}.tif"] = tiff(rgb, photometric=2, bps=8,
                                   compression=5, rows_per_strip=16)
        out[f"packbits_{i}.tif"] = tiff(rgb, photometric=2, bps=8,
                                        compression=32773,
                                        rows_per_strip=16)
        out[f"bmp24_{i}.bmp"] = _pillow(rgb, "BMP")
        out[f"gif_{i}.gif"] = _pillow(Image.fromarray(rgb).quantize(256),
                                      "GIF")
    return out


SUFFIXES = (".tif", ".bmp", ".gif")


def file_digests(path: Path) -> dict:
    """The size (``Image.open(path).size``) and the sha256 of Pillow's
    ``convert("RGB")`` (the JAX loader; null where Pillow cannot load the
    file), of the JAX eval's reader (``cv2.imread``, or Pillow where it
    returns None) and of ``np.asarray(Image.open(path))``, each file opened
    by its path as the JAX package opens it."""
    import cv2
    from PIL import Image

    with Image.open(path) as im:
        size = list(im.size)
    try:
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        with Image.open(path) as im:
            raw = np.asarray(im)
    except OSError:
        rgb = raw = None
    cv = cv2.imread(str(path), cv2.IMREAD_COLOR
                    | cv2.IMREAD_IGNORE_ORIENTATION)
    eval_rgb = rgb if cv is None else cv[..., ::-1]
    return {"size": size, "sha256": None if rgb is None else digest(rgb),
            "opencv_sha256": digest(eval_rgb), "opencv_none": cv is None,
            "raw_shape": None if raw is None else list(raw.shape),
            "raw_dtype": None if raw is None else raw.dtype.str,
            "raw_sha256": None if raw is None else digest_raw(raw)}


def generate(root: Path = RASTER) -> None:
    """Writes the raster fixtures and their digests under ``root``."""
    root = Path(root)
    for sub, files in (("coverage", {**tiff_coverage(), **bmp_coverage(),
                                     **gif_coverage()}),
                       ("timing", timing_frames())):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for name, data in files.items():
            (root / sub / name).write_bytes(data)
    video_dataset(root / "video")
    digests = {p.relative_to(root).as_posix(): file_digests(p)
               for p in sorted(root.rglob("*")) if p.suffix in SUFFIXES}
    (root / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    generate(Path(sys.argv[1]) if len(sys.argv) > 1 else RASTER)
