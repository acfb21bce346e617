"""Writes the simple-format fixtures under
``sam2_video_tpu_torch/data/fixtures/simple`` from seeds, and their
digests:

- ``coverage/``: small files (at most 40 x 40), one per kind that the
  port's readers (``sam2_video_tpu_torch/data/simple_formats.py``) decode
  or refuse: ASCII and binary Netpbm with comments and maxvals 1, 100,
  255, 1000 and 65535 (16-bit samples such as 129, which tell ``v >> 8``
  from ``(v + 128) // 257``), an ASCII file whose last value has no
  whitespace after it, Pillow's ``P0CMYK`` / ``Py*`` magics; PAM of each
  TUPLTYPE OpenCV knows, 8 and 16 bits; ``Pf`` of both byte orders and
  ``PF``; Sun raster of 1, 4, 8, 24 and 32 bits, types 0-3, raw and RLE,
  with and without a colour map; TGA of image types 1, 2, 3, 9, 10 and 11,
  colour maps of 16, 24 and 32-bit entries, 1, 8, 16, 24 and 32-bit
  pixels, every orientation, an image ID, RLE packets across rows; SGI of
  8 and 16 bits and 1, 3 and 4 channels, verbatim and RLE; PCX of 1 bit,
  1-bit planes (2 and 4), 8 bits (grey and palette) and 24 bits, padded
  rows; a two-page DCX; QOI of 3 and 4 channels (every op); XBM; Radiance
  HDR flat, with new-style RLE scanlines and with old-style run pixels;
  DIB; and refused files: a TGA with a 10-byte image ID (Pillow's PCX
  plugin takes it and raises), 15-bit TGA;
- ``video/``: a COCO-RLE video dataset of 2 videos x 8 frames of 240x320
  (the JPEG fixtures' frames, posterised to 8 levels a channel, and their
  annotations), frame i of each video in the i-th of P6 PPM, P5 PGM, Sun
  RLE, TGA RLE, SGI RLE, 24-bit PCX, QOI and 8-bit DIB, kinds on which the
  two readers agree, read with ``image_root``;
- ``timing/``: one 1280x1024 frame (EndoVis's size) of posterised smooth
  content as QOI and as RLE TGA (the 240x320 decode times are taken on
  the video's frames);
- ``digests.json``: for every file the format Pillow opens it as, its size
  (``Image.open(f).size``; null where ``Image.open`` raises) and the
  sha256 of Pillow's ``convert("RGB")`` (``sha256``; null where Pillow
  raises), of the JAX eval's reader (OpenCV's ``imread``, or Pillow where
  that returns None: ``opencv_sha256``, null where both raise, with
  ``opencv_none``) and of ``np.asarray(Image.open(f))`` (``raw_*``).

Pillow writes what it can (PPM / PGM / PBM, TGA raw and RLE, SGI
verbatim, PCX, QOI, XBM, DIB), OpenCV writes Sun, PAM, ``PF`` and HDR;
the byte writers below write the rest. ``check_paths`` asserts that each
coverage file takes the path it was made for.
``tests/test_torch_port_simple.py`` regenerates the files and asks for the
same bytes. To rewrite them: ``python tests/simple_fixtures.py``.
"""

from __future__ import annotations

import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SIMPLE = REPO / "sam2_video_tpu_torch" / "data" / "fixtures" / "simple"
LARGE_HW = (1024, 1280)
# what Image.open and load raise on a file Pillow refuses
PILLOW_ERRORS = (OSError, ValueError, SyntaxError, IndexError, TypeError,
                 KeyError, EOFError, struct.error)
# the video's frame kinds, in order: (extension, writer name)
VIDEO_KINDS = ((".ppm", "P6 PPM"), (".pgm", "P5 PGM"),
               (".ras", "8-bit Sun RLE with a colour map"),
               (".tga", "TGA RLE"), (".sgi", "SGI RLE"),
               (".pcx", "24-bit PCX"), (".qoi", "QOI"),
               (".dib", "8-bit RLE8 DIB"))


def _pillow(img, fmt: str, **kw) -> bytes:
    from PIL import Image

    im = img if isinstance(img, Image.Image) else Image.fromarray(img)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _cv(img: np.ndarray, ext: str, *params) -> bytes:
    import cv2

    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def scene(h: int, w: int, seed: int) -> np.ndarray:
    import raster_fixtures

    return raster_fixtures.scene(h, w, seed)


def flat(h: int, w: int, seed: int) -> np.ndarray:
    """A scene posterised to 8 levels a channel: runs along the rows."""
    return (scene(h, w, seed) // 32 * 32 + 16).astype(np.uint8)


# ---------------------------------------------------------------------------
# Netpbm, PAM, PFM
# ---------------------------------------------------------------------------


def ascii_pnm(magic: bytes, w: int, h: int, vals, maxval=None,
              comments: bool = True, trailing: bytes = b"\n",
              per_line: int = 7, sep: bytes = b" ") -> bytes:
    """An ASCII Netpbm file: comments in the header and between values
    when ``comments``; ``trailing`` after the last value."""
    head = magic + (b"\n# made by simple_fixtures\n" if comments else b"\n")
    head += b"%d %d" % (w, h) + (b" # size\n" if comments else b"\n")
    if maxval is not None:
        head += b"%d\n" % maxval
    vals = [int(v) for v in np.asarray(vals).reshape(-1)]
    lines = []
    for i in range(0, len(vals), per_line):
        line = sep.join(b"%d" % v for v in vals[i:i + per_line])
        if comments and i % (3 * per_line) == per_line:
            line += b" # a comment between values"
        lines.append(line)
    return head + b"\n".join(lines) + trailing


def binary_pnm(magic: bytes, w: int, h: int, maxval: int,
               samples: np.ndarray) -> bytes:
    body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + b"\n%d %d\n%d\n" % (w, h, maxval) + body


def pam(w: int, h: int, depth: int, maxval: int, samples: np.ndarray,
        tupltype: str | None) -> bytes:
    head = b"P7\n# a comment\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype.encode() + b"\n"
    body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + b"ENDHDR\n" + body


def pfm(values: np.ndarray, little: bool, scale: float = 1.0) -> bytes:
    """A PFM file, rows bottom to top: ``Pf`` of [h, w], ``PF`` of
    [h, w, 3]."""
    magic = b"Pf" if values.ndim == 2 else b"PF"
    h, w = values.shape[:2]
    s = -abs(scale) if little else abs(scale)
    body = values[::-1].astype("<f4" if little else ">f4").tobytes()
    return magic + b"\n%d %d\n%s\n" % (w, h, repr(s).encode()) + body


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------


def sun_rle(stream: bytes) -> bytes:
    """Sun byte-encoded RLE of one stream (runs may cross rows): runs of
    3 or more as 0x80 n-1 v, a 0x80 byte as 0x80 0."""
    out, i = bytearray(), 0
    while i < len(stream):
        j = i
        while j < len(stream) and stream[j] == stream[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3:
            out += bytes([0x80, n - 1, stream[i]])
            i = j
        elif stream[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(stream[i])
            i += 1
    return bytes(out)


def sun(w: int, h: int, depth: int, ftype: int, body: bytes,
        cmap: bytes = b"", maptype: int | None = None) -> bytes:
    if maptype is None:
        maptype = 1 if cmap else 0
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       maptype, len(cmap)) + cmap + body


def sun_rows(rows: np.ndarray) -> bytes:
    """Byte rows padded to 16 bits."""
    pad = (-rows.shape[1]) % 2
    return np.pad(rows, ((0, 0), (0, pad)), constant_values=0xEE).tobytes()


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def tga_rle(stream: bytes, unit: int, width: int) -> bytes:
    """TGA RLE of a stream of ``unit``-byte pixels in rows of ``width``:
    runs of 2 or more as run packets, which end at their row's end (Pillow
    refuses a run across rows), the rest literal (literal packets cross
    rows)."""
    px = [stream[i:i + unit] for i in range(0, len(stream), unit)]
    out, i = bytearray(), 0
    while i < len(px):
        j = i
        stop = (i // width + 1) * width
        while j < stop and px[j] == px[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += px[i]
            i = j
            continue
        j = i + 1
        while j < len(px) and j - i < 128 and (j + 1 >= len(px)
                                                or px[j] != px[j + 1]):
            j += 1
        out.append(j - i - 1)
        out += b"".join(px[i:j])
        i = j
    return bytes(out)


def tga(w: int, h: int, itype: int, depth: int, body: bytes, *,
        orient: int = 0x20, image_id: bytes = b"", cmap: bytes = b"",
        map_start: int = 0, map_len: int = 0, map_depth: int = 0) -> bytes:
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if map_len else 0,
                       itype, map_start, map_len, map_depth, 0, 0, w, h,
                       depth, orient)
    return head + image_id + cmap + body


def tga_pixels(img: np.ndarray, orient: int) -> np.ndarray:
    """Rows and columns in the file order of ``orient``."""
    if not orient & 0x20:
        img = img[::-1]
    if orient & 0x10:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def bgr15(rgb: np.ndarray, alpha_bit: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.uint16) >> 3 for k in range(3))
    return (r << 10 | g << 5 | b | (alpha_bit.astype(np.uint16) << 15)
            ).astype("<u2")


# ---------------------------------------------------------------------------
# SGI, PCX, DCX, HDR
# ---------------------------------------------------------------------------


def sgi_rle_row(samples: np.ndarray, bpc: int) -> bytes:
    """One channel row of SGI RLE: copy chunks and runs of up to 127
    samples (runs of 3 or more), then a zero-length terminator."""
    s = [int(v) for v in samples]
    enc = (lambda v: bytes([v])) if bpc == 1 else (
        lambda v: struct.pack(">H", v))
    atom = (lambda c: bytes([c])) if bpc == 1 else (
        lambda c: struct.pack(">H", c))
    out, i = bytearray(), 0
    while i < len(s):
        j = i
        while j < len(s) and s[j] == s[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += atom(j - i) + enc(s[i])
            i = j
            continue
        j = i + 1
        while j < len(s) and j - i < 127 and not (
                j + 2 < len(s) and s[j] == s[j + 1] == s[j + 2]):
            j += 1
        out += atom(0x80 | (j - i)) + b"".join(enc(v) for v in s[i:j])
        i = j
    return bytes(out + atom(0))


def sgi(img: np.ndarray, bpc: int = 1, rle: bool = True,
        dimension: int | None = None) -> bytes:
    """An SGI file of [h, w, z] samples (uint8, or uint16 at ``bpc`` 2),
    RLE (rows bottom to top, tables of offsets and lengths) or
    verbatim."""
    h, w, z = img.shape
    if dimension is None:
        dimension = 3 if z > 1 else 2
    head = struct.pack(">HBBHHHHIII", 474, int(rle), bpc, dimension, w, h, z,
                       0, (1 << 8 * bpc) - 1, 0).ljust(512, b"\0")
    planes = img[::-1].transpose(2, 0, 1)
    if not rle:
        dt = ">u2" if bpc == 2 else np.uint8
        return head + planes.astype(dt).tobytes()
    rows = [[sgi_rle_row(planes[c, y], bpc) for y in range(h)]
            for c in range(z)]
    start = 512 + 8 * h * z
    offs, lens, body = [], [], bytearray()
    for c in range(z):
        for y in range(h):
            offs.append(start + len(body))
            lens.append(len(rows[c][y]))
            body += rows[c][y]
    n = h * z
    return head + struct.pack(f">{n}I", *offs) + struct.pack(
        f">{n}I", *lens) + bytes(body)


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX RLE of byte rows, runs within a row (counts up to 63; bytes of
    0xC0 and above always as runs)."""
    out = bytearray()
    for row in rows:
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 63:
                j += 1
            if j - i > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), row[i]])
                i = j
            else:
                out.append(row[i])
                i += 1
    return bytes(out)


def pcx_planar(idx: np.ndarray, planes: int, palette: np.ndarray,
               stride: int | None = None) -> bytes:
    """A PCX of 1-bit planes (2 or 4) of [h, w] indices, 16-colour header
    palette, rows of ``stride`` bytes a plane (default even)."""
    h, w = idx.shape
    sb = (w + 7) // 8
    if stride is None:
        stride = sb + sb % 2
    rows = []
    for y in range(h):
        row = bytearray()
        for k in range(planes):
            bits = np.packbits(((idx[y] >> k) & 1).astype(np.uint8))
            row += bytes(bits) + bytes(stride - sb)
        rows.append(np.frombuffer(bytes(row), np.uint8))
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 72,
                       72) + palette.astype(np.uint8).tobytes().ljust(48,
                                                                      b"\0")
    head += struct.pack("<BBHH", 0, planes, stride, 1).ljust(128 - 64, b"\0")
    return head + pcx_rle(np.stack(rows))


def dcx(pages) -> bytes:
    offs, body = [], b""
    start = 4 + 4 * (len(pages) + 1)
    for p in pages:
        offs.append(start + len(body))
        body += p
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(
        f"<{len(offs) + 1}I", *offs, 0) + body


def rgbe(rgb: np.ndarray) -> np.ndarray:
    """float [n, 3] -> RGBE bytes [n, 4] (rgbe.cpp's float2rgbe)."""
    v = rgb.max(-1).astype(np.float64)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0, m * 256.0 / np.where(v > 0, v, 1))
    q = np.zeros((len(rgb), 4), np.uint8)
    q[:, :3] = (rgb * scale[:, None]).astype(np.uint8)
    q[:, 3] = np.where(v < 1e-32, 0, e + 128)
    return q


def hdr_rle_line(q: np.ndarray) -> bytes:
    """One new-style RLE scanline of [w, 4] RGBE bytes."""
    w = len(q)
    out = bytearray([2, 2, w >> 8, w & 255])
    for c in range(4):
        s = q[:, c]
        i = 0
        while i < w:
            j = i
            while j < w and s[j] == s[i] and j - i < 127:
                j += 1
            if j - i >= 4:
                out += bytes([128 + j - i, s[i]])
                i = j
                continue
            j = i + 1
            while j < w and j - i < 128 and not (
                    j + 3 < w and s[j] == s[j + 1] == s[j + 2] == s[j + 3]):
                j += 1
            out += bytes([j - i]) + bytes(s[i:j])
            i = j
    return bytes(out)


def hdr(rgb: np.ndarray, rle: bool = True, old_runs: bool = False,
        magic: bytes = b"#?RADIANCE") -> bytes:
    h, w, _ = rgb.shape
    head = magic + b"\n# a comment\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n"
    head += b"-Y %d +X %d\n" % (h, w)
    q = rgbe(rgb.reshape(-1, 3)).reshape(h, w, 4)
    if rle:
        return head + b"".join(hdr_rle_line(q[y]) for y in range(h))
    body, saved = bytearray(), 0
    for y in range(h):
        x = 0
        while x < w:
            n = 1
            while old_runs and x + n < w and (q[y, x + n] == q[y, x]).all():
                n += 1
            body += q[y, x].tobytes()
            if n > 2:
                body += bytes([1, 1, 1, n - 1])   # an old-style run
                saved += n - 2
            else:
                n = 1
            x += n
    # rgbe.cpp reads a run as one pixel: pixels enough for it at the end
    return head + bytes(body) + q[-1, -1].tobytes() * saved


# ---------------------------------------------------------------------------
# The coverage files
# ---------------------------------------------------------------------------


def _netpbm_files(g) -> dict:
    from PIL import Image

    out = {}
    rgb, grey = scene(17, 23, 1), scene(19, 13, 2)[..., 1]
    bw = grey > 128
    out["p1_ascii_comments.pbm"] = ascii_pnm(b"P1", 13, 19, bw, sep=b"",
                                             per_line=13)
    out["p2_ascii_maxval100.pgm"] = ascii_pnm(
        b"P2", 13, 19, grey.astype(np.int64) * 100 // 255, 100)
    out["p2_ascii_no_trailing_space.pgm"] = ascii_pnm(
        b"P2", 13, 19, grey, 255, comments=False, trailing=b"")
    out["p3_ascii_maxval255.ppm"] = ascii_pnm(b"P3", 23, 17, rgb, 255)
    v16 = g.integers(0, 1000, (9, 7, 3))
    v16[0, :4, 0] = [0, 129, 500, 999]
    out["p3_ascii_maxval1000.ppm"] = ascii_pnm(b"P3", 7, 9, v16, 1000)
    w16 = g.integers(0, 65536, (9, 7))
    w16[0, :4] = [0, 129, 40000, 65535]
    out["p2_ascii_maxval65535.pgm"] = ascii_pnm(b"P2", 7, 9, w16, 65535)
    out["p4.pbm"] = _pillow(Image.fromarray(bw), "PPM")
    out["p5.pgm"] = _pillow(grey, "PPM")
    out["p6.ppm"] = _pillow(rgb, "PPM")
    out["p5_maxval1.pgm"] = binary_pnm(b"P5", 13, 19, 1, bw)
    m100 = grey.astype(np.int64) * 100 // 255
    m100[0, :4] = [0, 1, 50, 100]
    out["p5_maxval100.pgm"] = binary_pnm(b"P5", 13, 19, 100, m100)
    out["p6_maxval100.ppm"] = binary_pnm(
        b"P6", 23, 17, 100, rgb.astype(np.int64) * 100 // 255)
    m1000 = grey.astype(np.int64) * 1000 // 255
    m1000[0, :4] = [0, 3, 500, 1000]
    out["p5_maxval1000.pgm"] = binary_pnm(b"P5", 13, 19, 1000, m1000)
    m65535 = g.integers(0, 65536, (19, 13))
    m65535[0, :4] = [0, 129, 40000, 65535]
    out["p5_maxval65535.pgm"] = binary_pnm(b"P5", 13, 19, 65535, m65535)
    c65535 = g.integers(0, 65536, (17, 23, 3))
    c65535[0, 0] = [129, 300, 40000]
    out["p6_maxval65535.ppm"] = binary_pnm(b"P6", 23, 17, 65535, c65535)
    out["p6_maxval1000.ppm"] = binary_pnm(b"P6", 23, 17, 1000,
                                          c65535 * 1000 // 65535)
    cmyk = g.integers(0, 256, (9, 11, 4))
    out["p0cmyk.pnm"] = binary_pnm(b"P0CMYK", 11, 9, 255, cmyk)
    out["pyp.pnm"] = binary_pnm(b"PyP", 11, 9, 255, cmyk[..., 0])
    out["pyrgba.pnm"] = binary_pnm(b"PyRGBA", 11, 9, 255, cmyk)
    f = np.array([[-0.1, 0.5, 0.999, 1.4, 254.7, 255.5, 300.0]],
                 np.float32).repeat(3, 0)
    f[1] = g.uniform(-10, 300, 7)
    out["pf_little.pfm"] = pfm(f, True)
    out["pf_big.pfm"] = pfm(f, False)
    out["pf_pillow.pfm"] = _pillow(Image.fromarray(
        (grey / 0.9).astype(np.float32)), "PPM")
    col = g.uniform(-0.5, 300, (5, 6, 3)).astype(np.float32)
    col[0, 0] = [0.5, 1.5, 2.5]
    out["pF_little.pfm"] = pfm(col, True)
    out["pF_big_scale4.pfm"] = pfm(col * 4, False, 4.0)
    out["pF_opencv.pfm"] = _cv((rgb / 100.0).astype(np.float32), ".pfm")
    return out


def _pam_files(g) -> dict:
    import cv2

    out = {}
    rgb, grey = scene(11, 9, 3), scene(11, 9, 4)[..., 0]
    out["pam_rgb_opencv.pam"] = _cv(rgb[..., ::-1].copy(), ".pam",
                                    cv2.IMWRITE_PAM_TUPLETYPE,
                                    cv2.IMWRITE_PAM_FORMAT_RGB)
    out["pam_grayscale_opencv.pam"] = _cv(grey, ".pam",
                                          cv2.IMWRITE_PAM_TUPLETYPE,
                                          cv2.IMWRITE_PAM_FORMAT_GRAYSCALE)
    out["pam_no_tupltype_rgb.pam"] = pam(9, 11, 3, 255, rgb, None)
    out["pam_grayscale_maxval100.pam"] = pam(9, 11, 1, 100, grey // 3,
                                             "GRAYSCALE")
    rgb16 = g.integers(0, 65536, (11, 9, 3))
    rgb16[0, 0] = [129, 300, 40000]
    out["pam_rgb16.pam"] = pam(9, 11, 3, 65535, rgb16, "RGB")
    out["pam_grayscale_alpha_w1.pam"] = pam(
        1, 11, 2, 255, g.integers(0, 256, (11, 1, 2)), "GRAYSCALE_ALPHA")
    out["pam_rgb_alpha_w1.pam"] = pam(1, 11, 4, 255,
                                      g.integers(0, 256, (11, 1, 4)),
                                      "RGB_ALPHA")
    out["pam_blackandwhite.pam"] = pam(9, 11, 1, 1, grey > 128,
                                       "BLACKANDWHITE")
    return out


def _sun_files(g) -> dict:
    out = {}
    rgb, grey = flat(13, 9, 5), flat(13, 9, 6)[..., 0]
    rgbx = np.concatenate([rgb, g.integers(0, 256, (13, 9, 1))], -1)
    # OpenCV leaves the pad byte of an odd row unset: even rows only
    wide = flat(13, 10, 17)
    out["sun_24_opencv.ras"] = _cv(wide[..., ::-1].copy(), ".ras")
    out["sun_8_opencv.ras"] = _cv(wide[..., 0].copy(), ".ras")
    bgr = rgb[..., ::-1].reshape(13, -1)
    out["sun_24_old.ras"] = sun(9, 13, 24, 0, sun_rows(bgr))
    out["sun_24_rgb_order.ras"] = sun(9, 13, 24, 3,
                                      sun_rows(rgb.reshape(13, -1)))
    out["sun_32_standard.ras"] = sun(9, 13, 32, 1, sun_rows(
        rgbx[..., [3, 2, 1, 0]].reshape(13, -1)))
    out["sun_32_rgb_order.ras"] = sun(9, 13, 32, 3, sun_rows(
        rgbx.reshape(13, -1)))
    bits = np.packbits(grey > 100, axis=1)
    out["sun_1_standard.ras"] = sun(9, 13, 1, 1, sun_rows(bits))
    cmap2 = bytes([200, 10, 30, 220, 90, 40])
    out["sun_1_colour_map.ras"] = sun(9, 13, 1, 1, sun_rows(bits), cmap2)
    idx = (grey // 32).astype(np.uint8)
    idx[0, 0] = 7                          # past the 6-entry map
    cmap = np.stack([np.arange(6) * 40, 250 - np.arange(6) * 30,
                     np.arange(6) * 7]).astype(np.uint8).tobytes()
    out["sun_8_colour_map.ras"] = sun(9, 13, 8, 1, sun_rows(idx), cmap)
    four = np.packbits(np.unpackbits(idx[..., None], axis=-1)[..., 4:]
                       .reshape(13, -1), axis=1)
    out["sun_4_grey.ras"] = sun(9, 13, 4, 1, sun_rows(four))
    runs = np.repeat(grey[:, :1], 9, 1)
    runs[2, 3] = 0x80
    runs[5] = 0x80
    out["sun_8_rle.ras"] = sun(9, 13, 8, 2, sun_rle(runs.tobytes()))
    out["sun_24_rle.ras"] = sun(9, 13, 24, 2, sun_rle(bgr.tobytes()))
    out["sun_8_colour_map_rle.ras"] = sun(9, 13, 8, 2,
                                          sun_rle(idx.tobytes()), cmap)
    out["sun_1_rle.ras"] = sun(9, 13, 1, 2, sun_rle(
        np.packbits(grey > 100, axis=1).tobytes()))
    return out


def _tga_files(g) -> dict:
    from PIL import Image

    out = {}
    rgb, grey = flat(11, 14, 7), flat(11, 14, 8)[..., 0]
    rgba = np.concatenate([rgb, g.integers(0, 256, (11, 14, 1),
                                           dtype=np.uint8)], -1)
    pim = Image.fromarray(rgb).quantize(12)
    for tag, im in (("rgb", Image.fromarray(rgb)),
                    ("rgba", Image.fromarray(rgba)),
                    ("l", Image.fromarray(grey)), ("p", pim),
                    ("la", Image.fromarray(rgba[..., :2].copy(), "LA")),
                    ("1", Image.fromarray(grey > 128))):
        out[f"tga_{tag}.tga"] = _pillow(im, "TGA")
        if tag != "1":
            out[f"tga_{tag}_rle.tga"] = _pillow(im, "TGA", rle=True)
    out["tga_1_rle.tga"] = _pillow(Image.fromarray(grey > 128), "TGA",
                                   rle=True)
    for orient in (0x00, 0x10, 0x20, 0x30):
        body = tga_pixels(rgb[..., ::-1], orient).tobytes()
        out[f"tga_orient_{orient:02x}.tga"] = tga(14, 11, 10, 24,
                                                  tga_rle(body, 3, 14),
                                                  orient=orient)
    idx = (grey // 32).astype(np.uint8)
    pal = g.integers(0, 256, (8, 3), dtype=np.uint8)
    for depth in (16, 24, 32):
        if depth == 16:
            cmap = bgr15(pal, np.arange(8) % 2).tobytes()
        elif depth == 24:
            cmap = pal[:, ::-1].tobytes()
        else:
            cmap = np.concatenate([pal[:, ::-1], np.full((8, 1), 7, np.uint8)],
                                  -1).tobytes()
        out[f"tga_map{depth}.tga"] = tga(14, 11, 1, 8, idx.tobytes(),
                                         cmap=cmap, map_len=8,
                                         map_depth=depth)
    out["tga_map24_start2_rle.tga"] = tga(
        14, 11, 9, 8, tga_rle(np.clip(idx, 2, 9).tobytes(), 1, 14),
        cmap=pal[:, ::-1].tobytes(), map_start=2, map_len=8, map_depth=24)
    px16 = bgr15(rgb, (grey > 128))
    out["tga_16.tga"] = tga(14, 11, 2, 16, px16.tobytes())
    out["tga_16_rle.tga"] = tga(14, 11, 10, 16, tga_rle(px16.tobytes(), 2,
                                                        14))
    out["tga_image_id.tga"] = tga(14, 11, 2, 24, rgb[..., ::-1].tobytes(),
                                  image_id=b"hello")
    # refused: PCX takes a TGA with a 10-byte ID (Image.open raises), and
    # Pillow reads neither a 15-bit map nor 15-bit pixels
    out["tga_image_id10.tga"] = _pillow(Image.fromarray(rgb), "TGA",
                                        id_section=b"0123456789")
    out["tga_map15.tga"] = tga(14, 11, 1, 8, idx.tobytes(),
                               cmap=bgr15(pal, np.zeros(8)).tobytes(),
                               map_len=8, map_depth=15)
    out["tga_15.tga"] = tga(14, 11, 2, 15, px16.tobytes())
    return out


def _sgi_files(g) -> dict:
    out = {}
    rgb, grey = flat(10, 21, 9), flat(10, 21, 10)[..., :1]
    rgba = np.concatenate([rgb, g.integers(0, 256, (10, 21, 1),
                                           dtype=np.uint8)], -1)
    for tag, img in (("l", grey), ("rgb", rgb), ("rgba", rgba)):
        out[f"sgi_{tag}.sgi"] = _pillow(img[..., 0] if tag == "l" else img,
                                        "SGI")
        out[f"sgi_{tag}_rle.sgi"] = sgi(img)
    w16 = rgb.astype(np.int64) * 257
    w16[0, 0] = [129, 300, 40000]
    out["sgi_rgb16.sgi"] = sgi(w16, bpc=2, rle=False)
    out["sgi_rgb16_rle.sgi"] = sgi(w16, bpc=2)
    out["sgi_l16_dim1.sgi"] = sgi(w16[:1, :, :1], bpc=2, rle=False,
                                  dimension=1)
    out["sgi_two_channels.sgi"] = sgi(rgba[..., :2])     # Pillow refuses
    return out


def _pcx_files(g) -> dict:
    from PIL import Image

    out = {}
    rgb, grey = flat(12, 19, 11), flat(12, 19, 12)[..., 0]
    out["pcx_1.pcx"] = _pillow(Image.fromarray(grey > 128), "PCX")
    out["pcx_l.pcx"] = _pillow(grey, "PCX")
    out["pcx_p.pcx"] = _pillow(Image.fromarray(rgb).quantize(20), "PCX")
    out["pcx_rgb.pcx"] = _pillow(rgb, "PCX")
    out["pcx_rgb_w1.pcx"] = _pillow(rgb[:, :1].copy(), "PCX")
    pal = g.integers(0, 256, (16, 3), dtype=np.uint8)
    idx4 = (grey // 16).astype(np.uint8)
    out["pcx_planar4.pcx"] = pcx_planar(idx4, 4, pal)
    out["pcx_planar4_w16.pcx"] = pcx_planar(np.tile(idx4, 2)[:, :16], 4, pal)
    out["pcx_planar2.pcx"] = pcx_planar(idx4 % 4, 2, pal)
    out["pcx_planar2_odd_stride.pcx"] = pcx_planar(idx4 % 4, 2, pal,
                                                   stride=3)
    out["dcx_two_pages.dcx"] = dcx([out["pcx_rgb.pcx"], out["pcx_p.pcx"]])
    return out


def _other_files(g) -> dict:
    from PIL import Image

    out = {}
    rgb = flat(17, 15, 13)
    rgba = np.concatenate([rgb, (scene(17, 15, 14)[..., :1] // 64 * 85)],
                          -1).astype(np.uint8)
    noisy = scene(17, 15, 15)
    ramp = (np.arange(15)[None, :, None] + np.array([10, 60, 200])).repeat(
        2, 0).astype(np.uint8)
    out["qoi_rgb.qoi"] = _pillow(np.concatenate([rgb[:9], ramp, noisy[11:]]),
                                 "QOI")
    out["qoi_rgba.qoi"] = _pillow(rgba, "QOI")
    out["qoi_index_unset.qoi"] = (b"qoif" + struct.pack(">II", 3, 2)
                                  + b"\x04\x00" + bytes([0x05, 0xC1, 0x3F,
                                                         0xFE, 9, 8, 7,
                                                         0x05])
                                  + bytes(7) + b"\x01")
    out["xbm.xbm"] = _pillow(Image.fromarray(rgb[..., 0] > 100), "XBM")
    out["xbm_hotspot.xbm"] = _pillow(Image.fromarray(rgb[..., 1] > 100),
                                     "XBM", hotspot=(3, 4))
    out["dib_rgb.dib"] = _pillow(rgb, "DIB")
    out["dib_p.dib"] = _pillow(Image.fromarray(rgb).quantize(30), "DIB")
    out["dib_1.dib"] = _pillow(Image.fromarray(rgb[..., 0] > 100), "DIB")
    f = (flat(9, 13, 16) / 96.0).astype(np.float32)
    f[0, :3] = [[0.195, 0.695, 1.5], [0, 0, 0], [1e-3, 70000, 2]]
    out["hdr_rle.hdr"] = hdr(f)
    out["hdr_flat.hdr"] = hdr(f, rle=False)
    out["hdr_old_runs.hdr"] = hdr(f, rle=False, old_runs=True)
    out["hdr_rgbe_magic.hdr"] = hdr(f, magic=b"#?RGBE")
    out["hdr_narrow.hdr"] = hdr(f[:, :5])
    out["hdr_opencv.hdr"] = _cv((rgb[..., ::-1] / 100.0).astype(np.float32),
                                ".hdr")
    return out


def coverage() -> dict:
    g = np.random.default_rng(20)
    files = {}
    for make in (_netpbm_files, _pam_files, _sun_files, _tga_files,
                 _sgi_files, _pcx_files, _other_files):
        files.update(make(g))
    return files


def check_paths(files: dict) -> None:
    """Each coverage file holds the path it was made for, read with the
    port's own parsers."""
    from sam2_video_tpu_torch.data import simple_formats as sf

    assert all(len(d) < 16 * 1024 for d in files.values())
    for name, data in files.items():
        pic = sf.pillow_open(data, name) if not name.startswith(
            ("tga_image_id10", "sgi_two")) else None
        if isinstance(pic, sf.Pic):
            assert max(pic.size) <= 40, name
    # runs that cross rows
    tga_rle_file = files["tga_rgb_rle.tga"]
    assert tga_rle_file[2] == 10
    assert any(name.startswith("tga_orient") for name in files)
    body = files["tga_orient_20.tga"][18:]
    pos, done, crossed = 0, 0, False
    while done < 14 * 11:
        n = (body[pos] & 0x7F) + 1
        run = body[pos] & 0x80
        across = done // 14 != (done + n - 1) // 14
        assert not (run and across), "a TGA run crosses a row"
        crossed |= across
        pos += 1 + (3 if run else 3 * n)
        done += n
    assert crossed, "no literal TGA packet crosses a row"
    rle = files["sun_8_rle.ras"][32:]
    assert b"\x80\x00" in rle and any(
        rle[i] == 0x80 and rle[i + 1] + 1 > 9 for i in range(len(rle) - 1))
    # every QOI op in the QOI files
    ops = set()
    for name in ("qoi_rgb.qoi", "qoi_rgba.qoi"):
        s = files[name][14:-8]
        i = 0
        while i < len(s):
            b = s[i]
            if b == 0xFE:
                ops.add("RGB")
                i += 4
            elif b == 0xFF:
                ops.add("RGBA")
                i += 5
            else:
                ops.add(("INDEX", "DIFF", "LUMA", "RUN")[b >> 6])
                i += 2 if b >> 6 == 2 else 1
    assert ops == {"RGB", "RGBA", "INDEX", "DIFF", "LUMA", "RUN"}, ops
    # HDR: new-style scanlines, and old-style run pixels read as pixels
    assert files["hdr_rle.hdr"].count(b"\x02\x02\x00\x0d") == 9
    assert b"\x01\x01\x01" in files["hdr_old_runs.hdr"]
    # PCX: a planar row of odd stride; the DCX's first page is 24-bit
    assert struct.unpack_from("<H", files["pcx_planar2_odd_stride.pcx"],
                              66)[0] == 3
    assert files["dcx_two_pages.dcx"][16 + 65] == 3
    # SGI RLE has copy and run chunks in 8 and 16 bits
    for name in ("sgi_rgb_rle.sgi", "sgi_rgb16_rle.sgi"):
        assert files[name][2] == 1
    # the PAM files OpenCV fills fully: depth 2 and 4 at width 1
    for name in ("pam_grayscale_alpha_w1.pam", "pam_rgb_alpha_w1.pam"):
        assert sf.pam_unset(files[name]) is None
    # 16-bit samples of 129
    assert b" 129 " in files["p2_ascii_maxval65535.pgm"]


# ---------------------------------------------------------------------------
# The video, the timing frames, the digests
# ---------------------------------------------------------------------------


def _indexed(rgb: np.ndarray):
    """Pillow's 256-colour quantisation: indices [h, w], palette [256, 3]."""
    from PIL import Image

    im = Image.fromarray(rgb).quantize(256)
    pal = np.zeros((256, 3), np.uint8)
    got = np.array(im.getpalette()[:768], np.uint8).reshape(-1, 3)
    pal[:len(got)] = got
    return np.asarray(im), pal


def encode_frame(rgb: np.ndarray, ext: str) -> bytes:
    """A video frame in the kind of ``ext`` (``VIDEO_KINDS``)."""
    import raster_fixtures

    h, w, _ = rgb.shape
    if ext == ".ppm":
        return _pillow(rgb, "PPM")
    if ext == ".pgm":
        return _pillow(rgb.mean(-1).astype(np.uint8), "PPM")
    if ext == ".ras":
        idx, pal = _indexed(rgb)
        return sun(w, h, 8, 2, sun_rle(idx.tobytes()), pal.T.tobytes())
    if ext == ".tga":
        return _pillow(rgb, "TGA", rle=True)
    if ext == ".sgi":
        return sgi(rgb)
    if ext == ".pcx":
        return _pillow(rgb, "PCX")
    if ext == ".qoi":
        return _pillow(rgb, "QOI")
    idx, pal = _indexed(rgb)
    return raster_fixtures.bmp(idx, 8, compression=1, palette=pal,
                               rle=raster_fixtures.rle_encode(idx, 8))[14:]


def video_dataset(root: Path) -> None:
    """The JPEG fixtures' video dataset (2 x 8 frames of 240x320, the same
    annotations), each frame posterised and written in its kind."""
    import raster_fixtures

    frames, ann = raster_fixtures._video_frames()
    (root / "images").mkdir(parents=True, exist_ok=True)
    for im in ann["images"]:
        rgb = (frames[im["file_name"]] // 32 * 32 + 16).astype(np.uint8)
        ext = VIDEO_KINDS[im["order_in_video"] % 8][0]
        im["file_name"] = im["file_name"].replace(".jpg", ext)
        (root / "images" / im["file_name"]).write_bytes(
            encode_frame(rgb, ext))
    (root / "annotations.json").write_text(json.dumps(ann))


def timing_frames() -> dict:
    """A 1280x1024 frame of posterised smooth content as QOI and RLE
    TGA."""
    import webp_fixtures

    large = (webp_fixtures.smooth(*LARGE_HW, seed=0) // 32 * 32).astype(
        np.uint8)
    return {"large.qoi": _pillow(large, "QOI"),
            "large_rle.tga": _pillow(large, "TGA", rle=True)}


def file_digests(path: Path) -> dict:
    """The format Pillow opens the file as and its size (null where
    ``Image.open`` raises), the sha256 of Pillow's ``convert("RGB")`` and
    ``np.asarray(Image.open(f))`` (null where they raise), and of the JAX
    eval's reader (OpenCV's ``imread``, else Pillow; null where both
    raise), each file opened by its path as the JAX package opens it."""
    import cv2
    from PIL import Image

    import raster_fixtures

    fmt = size = rgb = raw = None
    try:
        with Image.open(path) as im:
            fmt, size = im.format, list(im.size)
            rgb = np.asarray(im.convert("RGB"))
        with Image.open(path) as im:
            raw = np.asarray(im)
    except PILLOW_ERRORS:                  # Pillow refuses: null digests
        pass
    cv = cv2.imread(str(path), cv2.IMREAD_COLOR
                    | cv2.IMREAD_IGNORE_ORIENTATION)
    eval_rgb = rgb if cv is None else cv[..., ::-1]
    return {"format": fmt, "size": size,
            "sha256": None if rgb is None else raster_fixtures.digest(rgb),
            "opencv_sha256": None if eval_rgb is None
            else raster_fixtures.digest(eval_rgb),
            "opencv_none": cv is None,
            "raw_shape": None if raw is None else list(raw.shape),
            "raw_dtype": None if raw is None else raw.dtype.str,
            "raw_sha256": None if raw is None
            else raster_fixtures.digest_raw(raw)}


def generate(root: Path = SIMPLE) -> None:
    """Writes the simple-format fixtures and their digests under
    ``root``."""
    root = Path(root)
    files = coverage()
    check_paths(files)
    for sub, content in (("coverage", files), ("timing", timing_frames())):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for name, data in content.items():
            (root / sub / name).write_bytes(data)
    video_dataset(root / "video")
    digests = {p.relative_to(root).as_posix(): file_digests(p)
               for p in sorted(root.rglob("*"))
               if p.is_file() and p.suffix != ".json"}
    (root / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    generate(Path(sys.argv[1]) if len(sys.argv) > 1 else SIMPLE)
