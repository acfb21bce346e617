"""Frame files without Pillow or OpenCV: a JPEG decoder (libjpeg-turbo's
entropy decoding, Huffman and arithmetic, lossless prediction, IDCT,
upsampling and colour conversion, in C++ with a numpy reference), a PNG
reader and writer (zlib and numpy, the row unfilter in C++), TIFF, BMP and
GIF readers (their LZW, PackBits, RLE and predictor loops in C++,
``csrc/raster_decode.cpp``, with numpy references), a WebP reader
(``data/webp.py``: the container, VP8, VP8L and the alpha plane, their
loops in ``csrc/webp_decode.cpp``), readers of the simple formats that
ffmpeg writes (``data/simple_formats.py``: Netpbm, PAM, PFM, Sun raster,
TGA, SGI, PCX, DCX, QOI, XBM, Radiance HDR and DIB, their loops in
``csrc/simple_decode.cpp``) and Pillow's ``resize``
BILINEAR and NEAREST for 8-bit images, reproduced bit for bit (Pillow's
``libImaging/Resample.c`` and ``Geometry.c``), so the port's frames and
masks equal the JAX pipeline's, which reads them with Pillow in training
and in its tools and with OpenCV in its eval.

``read_rgb`` returns what ``Image.open(path).convert("RGB")`` gives, the
format told by the first bytes as Pillow's plugins tell it, in the order a
process that imports ``PIL.Image`` alone tries them
(``simple_formats.pillow_open``; ``reader="opencv"``: what ``cv2.imread``
with IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION gives, as RGB, or Pillow's
where it returns None, as the JAX eval falls back). A JPEG: 8-bit samples,
Huffman-coded baseline, extended or progressive, arithmetic-coded
sequential or progressive (SOF9, SOF10, with DAC conditioning), or
lossless Huffman (SOF3: predictors 1-7, point transforms); grey, three
components (YCbCr, or RGB by an Adobe transform 0, the ids 'R', 'G', 'B'
or, lossless, any ids without a JFIF marker) or four (CMYK, or YCCK by an
Adobe transform other than 0); any sampling factors that divide the
largest, restart intervals; EXIF orientation is not applied. A PNG of bit
depth 16 (grey, grey + alpha, RGB, RGBA), 8 or 1-8 (grey, palette), plain
or Adam7-interlaced: alpha is dropped, a palette is looked up. A TIFF's
first page: classic or BigTIFF, either byte order, strips or tiles,
planar configuration 1 or 2, fill order 1 or 2, uncompressed, LZW, Adobe
or old deflate, PackBits or JPEG (the JPEGTables spliced in), predictors 2
(8, 16, 32 bits) and 3 (float32); every sample kind of Pillow's
``TiffImagePlugin.OPEN_INFO`` but CIELab, unpacked as Pillow unpacks it
(its quirks included: uncompressed strips read as wide as the raw mode
asks, YCbCr that is not JPEG-compressed converted as libtiff converts it);
the Orientation tag applied as Pillow's loader applies it. A BMP: OS/2 and
Windows V3-V5 headers, 1-32 bits, bottom-up or top-down, BI_RGB, RLE8,
RLE4 and Pillow's BITFIELDS layouts. A GIF's first frame, on its screen.
A WebP: simple (``VP8 ``, ``VP8L``), extended (``VP8X`` with ``ALPH``,
``ICCP``, ``EXIF``, ``XMP ``) or animated (the first ``ANMF`` frame on its
zeroed canvas): VP8 lossy through libwebp's fancy upsampling, VP8L
lossless, alpha read (``read_raw``) and dropped by both readers; EXIF
orientation is not applied, by either reader. The simple formats
(``data/simple_formats.py``, whose docstring lists what each reader reads
of them and where the two differ): ASCII and binary Netpbm of maxval
1-65535, PAM (OpenCV only), PFM (``Pf`` both, ``PF`` OpenCV only), Sun
raster of 1, 4, 8, 24 and 32 bits, raw or RLE, with or without a colour
map, TGA of image types 1, 2, 3, 9, 10 and 11 in every orientation, SGI of
8 or 16 bits and 1-4 channels, verbatim or RLE, PCX of 1 bit, 1-bit planes
(2 or 4), 8 bits with a palette or grey and 24 bits in three planes, the
first page of a DCX, QOI, XBM, Radiance HDR (OpenCV only) and DIB.

The two readers' bits differ on: CMYK / YCCK JPEG (Pillow reads it
inverted and converts with ``MULDIV255``, OpenCV with ``k - ((255 - c) k
>> 8)``, ``cmyk_to_rgb``); 16-bit grey PNG and TIFF (Pillow clips each
sample to 255, OpenCV takes its high byte); 16-bit colour TIFF (Pillow's
high byte, OpenCV's ``(v + 128) // 257``); TIFF alpha (OpenCV premultiplies
unassociated alpha as ``(c a + 127) // 255`` and keeps associated alpha,
Pillow drops the one and divides the other out); CMYK TIFF (OpenCV
``(255 - k)(255 - c) // 255``, Pillow rounds); a tiled TIFF's mirror
orientation (OpenCV mirrors each column of tiles in place); 16-bit BMP
(OpenCV shifts 5 or 6 bits to 8, Pillow scales by 255 / 31 and 255 / 63);
a BMP palette of greys 0..n-1 (Pillow reads the file as mode "L", a
4-bit one 8 bits a pixel); BMP RLE deltas and RLE4 absolute runs of odd
length (Pillow reads two bytes past a delta and n // 2 bytes of a run);
GIF transparency and a GIF image smaller than its screen (OpenCV shows the
screen's background colour there, Pillow the transparent index's colour or
colour 0); the simple formats' differences (Netpbm of maxval other than
255, PAM, PFM, HDR and Sun, listed in ``data/simple_formats.py``). They
agree on every WebP kind. OpenCV reads nothing (the JAX
eval falls back to Pillow, which the port's eval reader returns) from
lossless grey JPEG, 32-bit and floating-point TIFF, TIFF of orientations
5-8, 2- and 4-bit grey TIFF, 16-bit BMP with bit fields in a V3+ header
and GIF indices past their table; Pillow reads nothing from uncompressed
YCbCr and big-endian BigTIFF, which OpenCV reads. What neither reads,
and the kinds the port does not read yet (the other formats Pillow opens
but the port does not read, JPEG 2000, AVIF, ICO and CUR among them,
CCITT, LZMA, ZSTD and old-style JPEG TIFF, CIELab TIFF, compressed planar
TIFF of modes other than RGB, CMYK and RGBA with unassociated alpha, BMP
with embedded JPEG or PNG; for the eval's reader a tiled TIFF of 2-byte
pixels whose width is not a whole number of tiles, whose rows ``imread``
misplaces, and a GIF without a colour table; a WebP that libwebp refuses,
truncated or corrupt), raise ``ValueError`` naming the file and what it
is. ``read_raw`` gives ``np.asarray(Image.open(path))`` (class-id masks:
16-bit grey as uint16), ``image_size`` ``Image.open(path).size`` from the
headers; both raise where Pillow raises (on PAM, ``PF`` and HDR too).
"""

from __future__ import annotations

import ctypes
import math
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np

from . import host_build, simple_formats, webp

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
    """What the first bytes of a file that the reader at hand refuses say
    it is (the formats Pillow opens that the port does not read yet are
    named, so that the ``ValueError`` says what the file is)."""
    if head.startswith(JPEG_SIGNATURE):
        return "a JPEG file, not a PNG"
    what = simple_formats.refusal(head)
    if what:
        return what
    for magic, kind in _OTHER_FORMATS:
        if head.startswith(magic):
            return f"{kind}, a format the port does not read yet"
    if head[:4] == b"RIFF":
        return "a RIFF file that is not WebP (AVI or WAV?), not an image"
    if head[4:8] == b"ftyp":
        return "an ISO media file (AVIF or HEIF?), a format the port does " \
            "not read yet"
    return ("not a PNG, JPEG, TIFF, BMP, GIF, WebP, Netpbm, Sun raster, "
            "TGA, SGI, PCX, DCX, QOI, XBM or DIB file (Pillow cannot "
            "identify it)")


# first bytes -> the format, for the error message of a refused file
_OTHER_FORMATS = (
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "a JPEG 2000 file"),
    (b"\xffO\xffQ", "a JPEG 2000 codestream"),
    (b"8BPS", "a Photoshop file"), (b"icns", "an ICNS file"),
    (b"DDS ", "a DDS file"),
    (b"%!PS", "a PostScript file"), (b"\xc5\xd0\xd3\xc6", "an EPS file"),
    (b"\x97JB2", "a JBIG2 file"), (b"FLIF", "a FLIF file"),
    (b"\x76\x2f\x31\x01", "an OpenEXR file"))


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
        return _lut(palette)[px[..., 0]]
    if ctype == 0:
        grey = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey[..., None], 3, axis=-1)
    if ctype == 4:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_raw(path: str | Path) -> np.ndarray:
    """An image file as ``np.asarray(Image.open(path))`` gives it, no
    colour conversion. A PNG: grey [H, W] (bool at 1 bit, 2- and 4-bit
    values scaled to 0..255 as Pillow's "L;2" / "L;4" unpackers do, uint16
    at 16 bits), palette indices [H, W], grey + alpha [H, W, 2] (at 16 bits
    Pillow opens it as RGBA: [H, W, 4], the grey repeated), RGB [H, W, 3],
    RGBA [H, W, 4]; 16-bit colour types as their samples' high bytes
    (class-id masks are read this way). A TIFF, BMP or GIF: the pixels of
    the mode Pillow opens it in (``decode_tiff`` and friends), a TIFF's
    orientation applied: "1" as bool, "L" / "P" [H, W] uint8, "I;16"
    uint16 (">u2" for "I;16B"), "I" int32, "F" float32, "LA" / "PA"
    [H, W, 2], "RGB", "RGBA", "CMYK". A WebP: "RGBA" [H, W, 4] where
    libwebp reports alpha, else "RGB" (``webp.webp_raw``). A simple format
    (``simple_formats``): the pixels of its Pillow mode, "I" as int32 and
    "F" as float32."""
    data = Path(path).read_bytes()
    kind = _kind(data, str(path))
    if isinstance(kind, simple_formats.Pic):
        return simple_formats.pic_raw(kind)
    if kind == "tiff":
        return tiff_raw(data, str(path))
    if kind == "bmp":
        return bmp_raw(data, str(path))
    if kind == "gif":
        return gif_raw(data, str(path))
    if kind == "webp":
        return webp.webp_raw(data, str(path))
    if kind == "other":
        raise ValueError(f"{path}: {_what(data[:16])}")
    px, depth, ctype, _ = _png_samples(data, str(path))
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
    """(width, height) of an image file from its header alone (PNG IHDR,
    JPEG SOFn, a TIFF's first directory, BMP and GIF headers, a WebP's
    canvas, a simple format's header), as Pillow's
    ``Image.open(path).size``: a TIFF of orientation 5-8 transposed; a
    file ``Image.open`` refuses raises."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        data = head + f.read()
    name = str(path)
    kind = _kind(data, name)
    if isinstance(kind, simple_formats.Pic):
        return kind.size
    if kind == "jpeg":
        return jpeg_header(data, name).size
    if kind == "tiff":
        return _Tiff(data, name).pillow().size
    if kind == "bmp":
        return _Bmp(data, name).size
    if kind == "gif":
        return _Gif(data, name).size
    if kind == "webp":
        return webp.webp_size(data, name)
    raise ValueError(f"{path}: {_what(head[:16])}")


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
    return _rgb(jpeg_components(data, name), reader)


# ---------------------------------------------------------------------------
# The raster codecs' loops (csrc/raster_decode.cpp, numpy references beside)
# ---------------------------------------------------------------------------


def _bind_raster(lib):
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.lzw_decode.restype = i64
    lib.lzw_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, p_u8,
                               i64]
    lib.packbits_decode.restype = i64
    lib.packbits_decode.argtypes = [ctypes.c_char_p, i64, p_u8, i64]
    lib.bmp_rle_decode.restype = i64
    lib.bmp_rle_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, i64,
                                   i64, i64, p_u8]
    lib.tiff_undiff.restype = None
    lib.tiff_undiff.argtypes = [p_u8, i64, i64, i64, i64, i64]


def _raster():
    return _helper("raster_decode", _bind_raster,
                   "TIFF, BMP and GIF frames are decoded with the numpy "
                   "references, whose LZW, PackBits and RLE loops run in "
                   "Python and are many times slower")


def lzw_decode_numpy(data: bytes, size: int, lsb: bool = False,
                     symbol_bits: int = 8, early: int = 1) -> bytes:
    """LZW of ``symbol_bits``-bit symbols with a Clear code (2^bits) and an
    end code (2^bits + 1), codes of bits + 1 up to 12 bits read MSB-first
    (TIFF) or LSB-first (GIF, ``lsb``), the width grown when the next
    free code reaches 2^width - ``early`` (TIFF's early change: 1; GIF:
    0) -> at most ``size`` bytes (fewer when the stream ends first). A
    code past the table raises ``ValueError``."""
    clear = 1 << symbol_bits
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, width, prev = list(base), symbol_bits + 1, None
    out = bytearray()
    acc = nacc = pos = 0
    n = len(data)
    while len(out) < size:
        while nacc < width and pos < n:
            if lsb:
                acc |= data[pos] << nacc
            else:
                acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        if nacc < width:
            break
        if lsb:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = (acc >> (nacc - width)) & ((1 << width) - 1)
        nacc -= width
        if code == clear:
            table, width, prev = list(base), symbol_bits + 1, None
            continue
        if code == clear + 1:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("corrupt LZW data (a code past the table)")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("corrupt LZW data (a code past the table)")
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) + early >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:size])


def lzw_decode(data: bytes, size: int, name: str, lsb: bool = False,
               symbol_bits: int = 8) -> bytes:
    """``lzw_decode_numpy`` (TIFF's early change unless ``lsb``: GIF)
    through the C++ helper when it builds."""
    early = 0 if lsb else 1
    lib = _raster()
    try:
        if lib is None:
            return lzw_decode_numpy(data, size, lsb, symbol_bits, early)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    out = np.empty(max(size, 1), np.uint8)
    n = lib.lzw_decode(data, len(data), int(lsb), symbol_bits, early, out,
                       size)
    if n < 0:
        raise ValueError(f"{name}: corrupt LZW data (a code past the table)")
    return out[:n].tobytes()


def packbits_numpy(data: bytes, size: int) -> bytes:
    """PackBits (libtiff's ``PackBitsDecode``): a header byte n >= 0 copies
    n + 1 bytes, n in -127..-1 repeats the next byte 1 - n times, -128 is
    skipped; stops at ``size`` bytes or at the data's end."""
    out, i, n = bytearray(), 0, len(data)
    while i < n and len(out) < size:
        h = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if h >= 0:
            out += data[i:i + h + 1]
            i += h + 1
        elif h != -128 and i < n:
            out += bytes([data[i]]) * (1 - h)
            i += 1
    return bytes(out[:size])


def packbits_decode(data: bytes, size: int) -> bytes:
    lib = _raster()
    if lib is None:
        return packbits_numpy(data, size)
    out = np.empty(max(size, 1), np.uint8)
    return out[:lib.packbits_decode(data, len(data), out, size)].tobytes()


def undifference_numpy(buf: np.ndarray, stride: int, nbytes: int,
                       order: str) -> np.ndarray:
    """TIFF's horizontal predictor (2) undone: each row's ``nbytes``-byte
    samples, read in byte order ``order``, summed modulo 2^(8 nbytes) with
    a stride of ``stride`` samples -> the rows with little-endian
    samples."""
    rows = buf.shape[0]
    v = np.ascontiguousarray(buf).view(f"{order}u{nbytes}").astype(
        f"<u{nbytes}").reshape(rows, -1)
    for s in range(min(stride, v.shape[1])):
        v[:, s::stride] = np.cumsum(v[:, s::stride], axis=1,
                                    dtype=v.dtype)
    return v.view(np.uint8).reshape(rows, -1)


def undifference(buf: np.ndarray, stride: int, nbytes: int,
                 order: str) -> np.ndarray:
    lib = _raster()
    if lib is None:
        return undifference_numpy(buf, stride, nbytes, order)
    out = np.ascontiguousarray(buf, np.uint8).copy()
    lib.tiff_undiff(out, out.shape[0], out.shape[1], stride, nbytes,
                    int(order == ">"))
    return out


def jpeg_components(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """libjpeg's output of a JPEG (``jpeg_samples_numpy``) through the C++
    helper when it builds: uint8 [H, W, 3] (grey repeated) or [H, W, 4]."""
    frame = jpeg_header(data, name)
    lib = _helper("jpeg_decode", _bind_jpeg,
                  "JPEG frames are decoded with the numpy reference, whose "
                  "entropy decoding loops in Python and is many times "
                  "slower")
    if lib is None:
        return jpeg_samples_numpy(data, name)
    channels = 4 if len(frame.comps) == 4 else 3
    out = np.empty((frame.height, frame.width, channels), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), frame.height, frame.width, channels,
                       out, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


# ---------------------------------------------------------------------------
# TIFF: Pillow's TiffImagePlugin (its own unpackers on uncompressed strips
# and tiles, libtiff's decoding of compressed ones) and OpenCV's imread
# (libtiff's TIFFRGBAImage), bit for bit
# ---------------------------------------------------------------------------

TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
# Pillow's Image.open raises DecompressionBombError past twice its
# MAX_IMAGE_PIXELS (1024 * 1024 * 1024 // 4 // 3)
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_size(width: int, height: int, name: str):
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of {width} x {height} pixels "
                         "passes Pillow's decompression bomb limit")
TIFF_COMPRESSIONS = {1: "uncompressed", 5: "LZW", 7: "JPEG",
                     8: "Adobe deflate", 32773: "PackBits",
                     32946: "deflate"}
# the other compressions Pillow knows (the port refuses them); Pillow does
# not open a file with any other code
TIFF_REFUSED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                6: "old-style JPEG", 32771: "word-aligned CCITT RLE",
                32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
                34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
# field type -> struct format of one value
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I",
               16: "Q", 17: "q", 18: "Q"}
# the raw modes that Pillow's table names but its unpackers lack
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}


def _tiff_open_info() -> dict:
    """Pillow 12.1.0's ``TiffImagePlugin.OPEN_INFO``: (byte order,
    photometric, sample formats, fill order, bits per sample, extra
    samples) -> (mode, raw mode). A row holds for both byte orders, for
    "II" alone where it ends in "-", and gives the "MM" mode and raw mode
    after the "II" ones where they differ."""
    rows = """
    0 1 1 1 - 1 1;I|0 1 2 1 - 1 1;IR|1 1 1 1 - 1 1|1 1 2 1 - 1 1;R
    0 1 1 2 - L L;2I|0 1 2 2 - L L;2IR|1 1 1 2 - L L;2|1 1 2 2 - L L;2R
    0 1 1 4 - L L;4I|0 1 2 4 - L L;4IR|1 1 1 4 - L L;4|1 1 2 4 - L L;4R
    0 1 1 8 - L L;I|0 1 2 8 - L L;IR|1 1 1 8 - L L|1 2 1 8 - L L
    1 1 2 8 - L L;R|1 1 1 8,8 2 LA LA|2 1 1 8,8,8 - RGB RGB
    2 1 2 8,8,8 - RGB RGB;R|2 1 1 8,8,8,8 - RGBA RGBA
    2 1 1 8,8,8,8 0 RGB RGBX|2 1 1 8,8,8,8,8 0,0 RGB RGBXX
    2 1 1 8,8,8,8,8,8 0,0,0 RGB RGBXXX|2 1 1 8,8,8,8 1 RGBA RGBa
    2 1 1 8,8,8,8,8 1,0 RGBA RGBaX|2 1 1 8,8,8,8,8,8 1,0,0 RGBA RGBaXX
    2 1 1 8,8,8,8 2 RGBA RGBA|2 1 1 8,8,8,8,8 2,0 RGBA RGBAX
    2 1 1 8,8,8,8,8,8 2,0,0 RGBA RGBAXX|2 1 1 8,8,8,8 999 RGBA RGBA
    3 1 1 1 - P P;1|3 1 2 1 - P P;1R|3 1 1 2 - P P;2|3 1 2 2 - P P;2R
    3 1 1 4 - P P;4|3 1 2 4 - P P;4R|3 1 1 8 - P P|3 1 1 8,8 0 P PX
    3 1 1 8,8 2 PA PA|3 1 2 8 - P P;R|5 1 1 8,8,8,8 - CMYK CMYK
    5 1 1 8,8,8,8,8 0 CMYK CMYKX|5 1 1 8,8,8,8,8,8 0,0 CMYK CMYKXX
    6 1 1 8 - L L|6 1 1 8,8,8 - RGB RGBX|8 1 1 8,8,8 - LAB LAB
    1 2 1 16 - I I;16S I I;16BS|0 3 1 32 - F F;32F F F;32BF
    1 2 1 32 - I I;32S I I;32BS|1 3 1 32 - F F;32F F F;32BF
    1 1 1 16 - I;16 I;16 I;16B I;16B
    2 1 1 16,16,16 - RGB RGB;16L RGB RGB;16B
    2 1 1 16,16,16,16 - RGBA RGBA;16L RGBA RGBA;16B
    2 1 1 16,16,16,16 0 RGB RGBX;16L RGB RGBX;16B
    2 1 1 16,16,16,16 1 RGBA RGBa;16L RGBA RGBa;16B
    2 1 1 16,16,16,16 2 RGBA RGBA;16L RGBA RGBA;16B
    5 1 1 16,16,16,16 - CMYK CMYK;16L CMYK CMYK;16B
    1 1 1 12 - I;16 I;12 -|0 1 1 16 - I;16 I;16 -|1 1 2 16 - I;16 I;16R -
    1 1 1 32 - I I;32N -"""
    info = {}
    for row in rows.replace("\n", "|").split("|"):
        f = row.split()
        if not f:
            continue
        photo, fmt, fill = int(f[0]), (int(f[1]),), int(f[2])
        bps = tuple(int(b) for b in f[3].split(","))
        extra = () if f[4] == "-" else tuple(int(e) for e in f[4].split(","))
        info[(b"II", photo, fmt, fill, bps, extra)] = (f[5], f[6])
        if len(f) == 7:
            info[(b"MM", photo, fmt, fill, bps, extra)] = (f[5], f[6])
        elif f[7] != "-":
            info[(b"MM", photo, fmt, fill, bps, extra)] = (f[7], f[8])
    return info


TIFF_OPEN_INFO = _tiff_open_info()
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# the numpy dtypes of Pillow's modes that are not uint8
_MODE_DTYPES = {"I;16": np.uint16, "I;16B": np.dtype(">u2"), "I": np.int32,
                "F": np.float32}


def _rawmode_bits(rawmode: str) -> int:
    """Bits a pixel that Pillow's unpacker of ``rawmode`` reads."""
    base, _, opt = rawmode.partition(";")
    opt = opt.rstrip("R")
    if base in ("1", "L", "P") and opt in ("", "I", "1", "2", "4", "2I",
                                           "4I"):
        return int(opt.rstrip("I") or (1 if base == "1" else 8))
    if base in ("I", "F"):
        return {"12": 12}.get(opt, 16 if opt.startswith("16") else 32)
    if opt in ("15", "16") and base == "BGR":     # BMP's 5-5-5 and 5-6-5
        return 16
    return (16 if opt.startswith("16") else 8) * len(base)


def _unpack(rawmode: str, mode: str, rows: np.ndarray, width: int,
            name: str) -> np.ndarray:
    """Pillow's ``Unpack.c`` for a raw mode of ``TIFF_OPEN_INFO`` (or one
    band letter of it): byte rows [n, >= row bytes] -> pixels of ``mode``
    [n, width(, bands)] as Pillow holds them (mode "1" as 0 / 255)."""
    if rawmode in _NO_UNPACKER:
        raise ValueError(f"{name}: TIFF raw mode {rawmode} has no unpacker "
                         "in Pillow, which cannot read it")
    base, _, opt = rawmode.partition(";")
    if opt.endswith("R"):                     # fill order 2: bits reversed
        rows, opt = _BITREV[rows], opt[:-1]
    n = rows.shape[0]
    if base in ("1", "L", "P") and opt in ("", "I", "1", "2", "4", "2I",
                                           "4I"):
        bits = _rawmode_bits(base + (";" + opt if opt else ""))
        v = _bit_values(rows, width, bits)
        top = (1 << bits) - 1
        if opt.endswith("I"):
            v = top - v
        if base == "1":
            return (v.astype(np.uint8) * 255).astype(np.uint8)
        return v if base == "P" else (v * (255 // top)).astype(np.uint8)
    if base == "I" and opt == "12":
        b = rows[:, :(width * 12 + 7) // 8].astype(np.uint16)
        out, m = np.empty((n, width), np.uint16), width // 2
        t = b[:, :3 * m].reshape(n, m, 3)
        out[:, 0:2 * m:2] = (t[..., 0] << 4) | (t[..., 1] >> 4)
        out[:, 1:2 * m:2] = ((t[..., 1] & 15) << 8) | t[..., 2]
        if width % 2:
            out[:, -1] = (b[:, 3 * m] << 4) | (b[:, 3 * m + 1] >> 4)
        return out
    if base in ("I", "F"):
        big = "B" in opt
        if opt.startswith("16"):
            v = rows[:, :2 * width].copy().view(">u2" if big else "<u2")
            if opt.endswith("S"):
                return v.view(">i2" if big else "<i2").astype(np.int32)
            return v.astype(">u2" if mode == "I;16B" else np.uint16)
        v = rows[:, :4 * width].copy()
        if base == "F":
            return v.view(">f4" if big else "<f4").astype(np.float32)
        return v.view(">i4" if big else "<i4").astype(np.int32)
    # one plane's band: for planar configuration 2 Pillow unpacks plane k
    # with the raw mode's k-th letter
    if len(base) == 1 and not opt:
        return rows[:, :width]
    k = len(base)
    if opt in ("16L", "16B", "16N"):          # the high byte of each sample
        px = rows[:, :2 * k * width].reshape(n, width, k, 2)[
            ..., 0 if opt == "16B" else 1]
    elif not opt:
        px = rows[:, :k * width].reshape(n, width, k)
    else:
        raise ValueError(f"{name}: TIFF raw mode {rawmode} is not known")
    lead = base.rstrip("X")
    if mode == "P":
        return np.ascontiguousarray(px[..., 0])
    px = np.ascontiguousarray(px[..., :len(lead)])
    return _unpremultiply(px) if lead == "RGBa" else px


def _bit_values(rows: np.ndarray, count: int, bits: int) -> np.ndarray:
    """The first ``count`` values of ``bits`` (1, 2, 4 or 8) bits each,
    MSB first, of each byte row -> uint8 [n, count]."""
    if bits == 8:
        return rows[:, :count]
    b = np.unpackbits(rows, axis=1)[:, :count * bits].reshape(
        rows.shape[0], count, bits)
    return (b << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
        -1, dtype=np.uint8)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's "RGBa" unpackers: colour * 255 // alpha clipped to 255,
    0 where alpha is 0."""
    a = px[..., 3:].astype(np.int32)
    c = np.minimum(px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1),
                   255)
    c = np.where(a == 0, 0, c)
    return np.concatenate([c, a], -1).astype(np.uint8)


class _Tiff:
    """The first image file directory of a TIFF and what Pillow's
    ``_setup`` makes of it: size, mode and raw mode, compression, layout;
    every refusal that the header shows raised as ``ValueError``."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        try:
            self._parse(data, name)
        except (IndexError, struct.error) as e:
            self.fail(f"truncated or corrupt TIFF header ({e})")

    def _parse(self, data: bytes, name: str):
        if data[:4] not in TIFF_SIGNATURES:
            raise ValueError(f"{name}: {_what(data[:8])}")
        self.order = data[:2]
        e = "<" if self.order == b"II" else ">"
        self.e = e
        self.big = data[2:4] in (b"+\0", b"\0+")
        if self.big:
            if len(data) < 16:
                self.fail("truncated BigTIFF header")
            first = struct.unpack(e + "Q", data[8:16])[0]
        else:
            first = struct.unpack(e + "I", data[4:8])[0]
        self.tags = self._ifd(first)
        self._setup()
        # Pillow's _open looks for 43 in the header's third byte, where a
        # big-endian BigTIFF has 0: it opens none, OpenCV reads them
        self.pillow_opens = not (self.big and self.order == b"MM")

    def pillow(self):
        if not self.pillow_opens:
            self.fail("big-endian BigTIFF is not supported for Pillow's "
                      "reader (Pillow 12.1.0 does not open it)")
        return self

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def _ifd(self, pos: int) -> dict:
        e, data = self.e, self.data
        cfmt, efmt, esize, inline = (("Q", "HHQ", 20, 8) if self.big
                                     else ("H", "HHI", 12, 4))
        csize = struct.calcsize(cfmt)
        if pos + csize > len(data):
            self.fail("TIFF directory beyond the end of the file")
        n = struct.unpack(e + cfmt, data[pos:pos + csize])[0]
        tags = {}
        for i in range(n):
            at = pos + csize + i * esize
            if at + esize > len(data):
                self.fail("truncated TIFF directory")
            tag, typ, count = struct.unpack(e + efmt, data[at:at + esize
                                                          - inline])
            if typ not in _TIFF_TYPES:
                continue
            fmt = _TIFF_TYPES[typ]
            size = struct.calcsize(e + fmt) * count
            if size <= inline:
                raw = data[at + esize - inline:at + esize - inline + size]
            else:
                off = struct.unpack(e + ("Q" if self.big else "I"),
                                    data[at + esize - inline:at + esize])[0]
                raw = data[off:off + size]
                if len(raw) < size:
                    continue
            if typ in (1, 2, 7):
                tags[tag] = bytes(raw) if typ in (2, 7) else list(raw)
            else:
                vals = struct.unpack(e + fmt * count, raw)
                if typ in (5, 10):
                    vals = [a / b if b else 0.0 for a, b in zip(vals[::2],
                                                                vals[1::2])]
                tags[tag] = list(vals)
        return tags

    def _setup(self):
        """Pillow's ``TiffImageFile._setup``."""
        t = self.tags
        comp = t.get(259, [1])[0]
        if comp in TIFF_REFUSED:
            self.fail(f"{TIFF_REFUSED[comp]}-compressed TIFF (compression "
                      f"{comp}) is not supported")
        if comp not in TIFF_COMPRESSIONS:
            self.fail(f"TIFF compression {comp} is not known (Pillow does "
                      "not open it)")
        self.compression = comp
        self.planar = t.get(284, [1])[0]
        photo = t.get(262, [0])[0]
        fill = t.get(266, [1])[0]
        if 256 not in t or 257 not in t:
            self.fail("TIFF without its image size")
        self.width, self.height = t[256][0], t[257][0]
        _check_size(self.width, self.height, self.name)
        self.orientation = t.get(274, [1])[0]
        fmt = tuple(t.get(339, [1]))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bps = tuple(t.get(258, [1]))
        extra = tuple(t.get(338, []))
        count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(extra)
        spp = t.get(277, [1])[0]
        if spp > 6:
            self.fail(f"TIFF with {spp} samples a pixel is not supported")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            self.fail("TIFF with an unknown data organization")
        key = (self.order, photo, fmt, fill, bps, extra)
        if key not in TIFF_OPEN_INFO:
            self.fail(f"TIFF of an unknown pixel mode: photometric {photo}, "
                      f"sample format {fmt}, fill order {fill}, bits "
                      f"{bps}, extra samples {extra}")
        self.mode, self.rawmode = TIFF_OPEN_INFO[key]
        self.photo, self.fill, self.bps, self.extra = photo, fill, bps, extra
        self.spp, self.count, self.fmt = spp, count, fmt
        if photo == 8:
            self.fail("CIELab TIFF (photometric 8) is not supported: "
                      "Pillow converts it to RGB through LittleCMS")
        self.tiled = 322 in t
        if self.tiled:
            self.tw, self.th = t[322][0], t.get(323, [0])[0]
            self.offsets, self.counts = t.get(324), t.get(325)
        else:
            self.tw = self.width
            self.th = t.get(278, [self.height])[0]
            self.offsets, self.counts = t.get(273), t.get(279)
        if not self.offsets:
            self.fail("TIFF with an unknown data organization")
        if self.compression != 1:
            if fill == 2:
                self.mode, self.rawmode = TIFF_OPEN_INFO[
                    key[:3] + (1,) + key[4:]]
            raw = self.rawmode
            if photo == 6 and comp == 7 and self.planar == 1:
                raw = "RGB"
            elif raw == "I;16":
                raw = "I;16N"
            elif raw.endswith((";16B", ";16L")):
                raw = raw[:-1] + "N"
            self.lib_rawmode = raw
        self.palette = None
        if self.mode in ("P", "PA"):
            cmap = t.get(320)
            if cmap is None:
                self.fail("palette TIFF without a colour map")
            self.cmap = np.array(cmap, np.int64).reshape(3, -1).T
            self.palette = (self.cmap >> 8).astype(np.uint8)

    @property
    def size(self) -> tuple[int, int]:
        """``Image.open(path).size``: transposed for orientations 5-8."""
        if self.orientation in (5, 6, 7, 8):
            return self.height, self.width
        return self.width, self.height

    def chunks(self):
        """(offset, byte count, plane, x, y, width, rows) of each strip or
        tile, as libtiff reads them (the plane's chunks in turn)."""
        across = -(-self.width // self.tw)
        down = -(-self.height // self.th)
        per = across * down
        planes = self.spp if self.planar == 2 else 1
        if len(self.offsets) < per * planes:
            self.fail("TIFF with fewer strips or tiles than its size needs")
        counts = self.counts or [0] * len(self.offsets)
        for i in range(per * planes):
            p, j = divmod(i, per)
            y, x = divmod(j, across)
            rows = self.th if self.tiled else min(self.th,
                                                  self.height - y * self.th)
            yield (self.offsets[i], counts[i], p, x * self.tw, y * self.th,
                   self.tw, rows)


def _raw_rows(data: bytes, offset: int, rows: int, nbytes: int,
              stride: int, fail) -> np.ndarray:
    """Pillow's raw decoder: ``rows`` rows of ``nbytes`` bytes from
    ``offset``, each ``stride`` bytes after the last (0: packed), read as
    far as they reach, past any strip's byte count -> [rows, >= nbytes]
    uint8; ``fail`` where the rows are wider than the stride or the file
    ends first."""
    skip = stride - nbytes if stride else 0
    if skip < 0:
        fail("rows wider than their stride for Pillow's raw decoder")
    need = rows * nbytes + max(rows - 1, 0) * skip
    buf = np.frombuffer(data[offset:offset + need], np.uint8)
    if buf.size < need:
        fail("truncated image data")
    return np.concatenate([buf, np.zeros(skip, np.uint8)]).reshape(
        rows, nbytes + skip)


def _tiff_pillow_raw(tif: _Tiff) -> np.ndarray:
    """Pillow's uncompressed path (``ImageFile.load`` with the raw decoder
    per strip or tile, as ``_setup`` lays them out): each reads from its
    offset as many bytes as its raw mode's unpacker needs, past its byte
    count when the raw mode is wider than the samples; planes of planar
    configuration 2 unpacked with the raw mode's letters in turn."""
    W, H = tif.width, tif.height
    letters = tif.mode if tif.mode in ("RGB", "RGBA", "CMYK") else None
    bands = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2}.get(
        tif.mode, 0)
    img = np.zeros((H, W, bands) if bands else (H, W),
                   _MODE_DTYPES.get(tif.mode, np.uint8))
    offsets, w, h = tif.offsets, tif.tw, tif.th
    if w == W and h == H and tif.planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    for off in offsets:
        stride = w * sum(tif.bps) / 8 if x + w > W else 0
        raw = tif.rawmode
        if tif.planar == 2:
            if layer >= len(raw):
                tif.fail("planar TIFF with more planes than Pillow reads")
            raw = raw[layer]
            if raw not in (letters or (tif.mode if tif.mode in (
                    "1", "L", "P", "I", "F") else "")):
                tif.fail(f"planar TIFF: Pillow has no unpacker of raw mode "
                         f"{raw} for mode {tif.mode}")
            stride /= tif.count
        x1, y1 = min(x + w, W), min(y + h, H)
        ew, rows = x1 - x, y1 - y
        buf = _raw_rows(tif.data, off, rows, (ew * _rawmode_bits(raw) + 7)
                        // 8, int(stride), lambda m: tif.fail("TIFF: " + m))
        px = _unpack(raw, tif.mode, buf, ew, tif.name)
        if tif.planar == 2 and letters:
            img[y:y1, x:x1, letters.index(raw)] = px
        else:
            img[y:y1, x:x1] = px
        x += w
        if x >= W:
            x, y = 0, y + h
            if y >= H:
                y, layer = 0, layer + 1
    return img



def _tiff_chunk(tif: _Tiff, raw: bytes, width: int, rows: int,
                samples: int, tables: bytes | None) -> np.ndarray:
    """One strip or tile decoded as libtiff decodes it: bits reversed for
    fill order 2, decompressed, the predictor undone, 16- and 32-bit
    samples in little-endian order -> [rows, row bytes] uint8."""
    bits = tif.bps[0]
    rb = (width * bits * samples + 7) // 8
    size = rows * rb
    if tif.fill == 2:
        raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    comp = tif.compression
    if comp == 7:
        return _tiff_jpeg_chunk(tif, raw, width, rows, samples, tables)
    buf = np.frombuffer(_tiff_decompress(tif, raw, size), np.uint8).reshape(
        rows, rb)
    # libtiff's LZW and deflate codecs undo the predictor; the others
    # ignore the tag
    predictor = tif.tags.get(317, [1])[0] if comp in (5, 8, 32946) else 1
    if predictor == 2:
        if bits not in (8, 16, 32):
            tif.fail(f"TIFF horizontal predictor with {bits}-bit samples "
                     "(libtiff does not undo it)")
        return undifference(buf, samples, bits // 8, tif.e)
    if predictor == 3:
        if tif.fmt != (3,) or bits != 32:
            tif.fail("TIFF floating-point predictor on samples that are not "
                     "32-bit floats")
        return _fp_accumulate(buf, samples)
    if predictor != 1:
        tif.fail(f"TIFF predictor {predictor} is not known")
    if tif.e == ">" and bits in (16, 32):
        return np.ascontiguousarray(buf.view(f">u{bits // 8}").astype(
            f"<u{bits // 8}").view(np.uint8))
    return buf


def _tiff_decompress(tif: _Tiff, raw: bytes, size: int) -> bytes:
    """One strip's or tile's bytes decompressed as libtiff does: exactly
    ``size`` bytes, or ``ValueError`` when the data holds fewer."""
    comp = tif.compression
    if comp == 1:
        out = raw[:size]
    elif comp == 5:
        out = lzw_decode(raw, size, tif.name)
    elif comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            tif.fail(f"corrupt deflate data in a TIFF strip or tile ({e})")
    else:
        out = packbits_decode(raw, size)
    if len(out) < size:
        tif.fail("truncated or corrupt TIFF strip or tile")
    return out[:size]


def _fp_accumulate(buf: np.ndarray, samples: int) -> np.ndarray:
    """libtiff's ``fpAcc`` for 32-bit floats: each row's bytes summed
    modulo 256 with a stride of ``samples``, then its four byte planes
    (most significant first) put back together as little-endian floats."""
    rows, rb = buf.shape
    acc = np.empty_like(buf)
    for s in range(min(samples, rb)):
        acc[:, s::samples] = np.cumsum(buf[:, s::samples], axis=1,
                                       dtype=np.uint8)
    n = rb // 4
    planes = acc.reshape(rows, 4, n)
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).reshape(
        rows, rb)


def _tiff_jpeg_chunk(tif: _Tiff, raw: bytes, width: int, rows: int,
                     samples: int, tables: bytes | None) -> np.ndarray:
    """A JPEG-compressed strip or tile (compression 7): an abbreviated
    stream, the JPEGTables segments put after its SOI, decoded as libtiff
    asks libjpeg to: YCbCr converted to RGB (JPEGCOLORMODE, photometric
    6), every other photometric's samples as stored (a JFIF marker or an
    Adobe transform 0 put in says which to the port's decoder)."""
    if tif.bps[0] != 8:
        tif.fail(f"{tif.bps[0]}-bit JPEG-compressed TIFF is not supported")
    if not raw.startswith(b"\xff\xd8"):
        tif.fail("JPEG-compressed TIFF strip without an SOI marker")
    mark = (JFIF_APP0 if tif.photo == 6 and tif.planar == 1
            else ADOBE_APP14_RGB)
    body = tables[2:-2] if tables and tables.startswith(b"\xff\xd8") else b""
    stream = raw[:2] + mark + body + raw[2:]
    frame = jpeg_header(stream, tif.name)
    if len(frame.comps) != samples or (tif.photo != 6 and any(
            (c["h"], c["v"]) != (1, 1) for c in frame.comps)):
        tif.fail("JPEG-compressed TIFF whose JPEG frame does not match its "
                 "samples")
    px = jpeg_components(stream, tif.name)[:, :, :samples]
    if px.shape[0] < rows or px.shape[1] < width:
        tif.fail("JPEG-compressed TIFF strip or tile smaller than its size")
    return np.ascontiguousarray(px[:rows, :width]).reshape(rows, -1)


JFIF_APP0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
ADOBE_APP14_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"


def _tiff_planes(tif: _Tiff) -> list:
    """Every plane as libtiff decodes it: [height, row bytes] uint8 (one
    plane, or one a sample for planar configuration 2)."""
    bits = tif.bps[0]
    if len(set(tif.bps)) != 1:
        tif.fail(f"TIFF with samples of different sizes {tif.bps}")
    samples = tif.spp if tif.planar == 1 else 1
    rb = (tif.width * bits * samples + 7) // 8
    planes = [np.zeros((tif.height, rb), np.uint8)
              for _ in range(tif.spp // samples)]
    tables = tif.tags.get(347)
    for off, count, p, x, y, w, rows in tif.chunks():
        chunk = _tiff_chunk(tif, tif.data[off:off + count], w, rows,
                            samples, tables)
        if (x * bits * samples) % 8:
            tif.fail("TIFF tile that does not start on a byte")
        x0 = x * bits * samples // 8
        n = min(rows, tif.height - y)
        m = min(chunk.shape[1], rb - x0)
        planes[p][y:y + n, x0:x0 + m] = chunk[:n, :m]
    return planes


def _ycbcr_tables(luma, refbw):
    """libtiff's ``TIFFYCbCrToRGBInit`` (tif_color.c: SHIFT 16, float32
    arithmetic, the coefficients' FIX rounding in double) -> the Y, Cr->R,
    Cb->B, Cr->G and Cb->G tables over 0..255."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def fix(v):
        v = min(max(v, f32(0)), f32(2))
        return int(float(f32(v * f32(65536))) + 0.5)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(f32(lr * f1) / lg)
    d3, d4 = fix(f3), -fix(f32(lb * f3) / lg)
    x = np.arange(-128, 128, dtype=np.int64)

    def code2v(c, rb, rw, cr):
        rb_i = int(f32(rb))
        den = f32(rw - rb) if f32(rw - rb) != 0 else f32(1)
        v = (c - rb_i).astype(f32) * f32(cr) / den
        return np.clip(v, f32(-4096), f32(4096)).astype(np.int64)

    cr = code2v(x, f32(refbw[4]) - f32(128), f32(refbw[5]) - f32(128), 127)
    cb = code2v(x, f32(refbw[2]) - f32(128), f32(refbw[3]) - f32(128), 127)
    y = code2v(x + 128, f32(refbw[0]), f32(refbw[1]), 255)
    half = 1 << 15
    return (y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def _tiff_ycbcr(tif: _Tiff) -> np.ndarray:
    """A YCbCr TIFF that is not JPEG-compressed, as libtiff's
    ``TIFFRGBAImage`` converts it (``TIFFYCbCrtoRGB`` over the tag 530
    subsampling blocks, 2 x 2 by default: h v Y samples, then Cb and Cr) ->
    uint8 [H, W, 3]. Both OpenCV's ``imread`` and, for a compressed file,
    Pillow read it so."""
    t = tif.tags
    if tif.planar != 1 or tif.bps[0] != 8:
        tif.fail("planar or 16-bit YCbCr TIFF is not supported")
    h, v = (list(t.get(530, [2, 2])) + [2])[:2]
    if h not in (1, 2, 4) or v not in (1, 2, 4) or v > h:
        tif.fail(f"YCbCr subsampling {h}x{v} is not supported")
    predictor = t.get(317, [1])[0] if tif.compression in (5, 8, 32946) \
        else 1
    if predictor not in (1, 2):
        tif.fail(f"YCbCr TIFF with predictor {predictor} is not supported")
    luma = t.get(529, [0.299, 0.587, 0.114])
    refbw = t.get(532, [0, 255, 128, 255, 128, 255])
    ytab, crr, cbb, crg, cbg = _ycbcr_tables(luma, refbw)
    unit = h * v + 2
    out = np.zeros((tif.height, tif.width, 3), np.uint8)
    for off, count, _, x, y, w, rows in tif.chunks():
        bw, bh = -(-w // h), -(-rows // v)
        raw = tif.data[off:off + count]
        if tif.fill == 2:
            raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
        raw = np.frombuffer(_tiff_decompress(tif, raw, bw * bh * unit),
                            np.uint8)
        if predictor == 2:
            # libtiff undoes it over "scanlines" of a block row / v bytes
            if (bw * unit) % v:
                tif.fail("YCbCr TIFF with a predictor over rows that split "
                         "a subsampling block is not supported")
            raw = undifference(raw.reshape(-1, bw * unit // v), 3, 1, "<")
        blocks = raw.reshape(bh, bw, unit).astype(np.int64)
        yy = blocks[..., :h * v].reshape(bh, bw, v, h).transpose(
            0, 2, 1, 3).reshape(bh * v, bw * h)
        cb = np.repeat(np.repeat(blocks[..., h * v], v, 0), h, 1)
        cr = np.repeat(np.repeat(blocks[..., h * v + 1], v, 0), h, 1)
        yv = ytab[yy]
        rgb = np.stack([yv + crr[cr], yv + ((cbg[cb] + crg[cr]) >> 16),
                        yv + cbb[cb]], -1)
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        n, m = min(rows, tif.height - y), min(w, tif.width - x)
        out[y:y + n, x:x + m] = rgb[:n, :m]
    return out


def _tiff_pillow_pixels(tif: _Tiff) -> np.ndarray:
    """The pixels of Pillow's mode for the file, before its orientation:
    the raw decoder's for an uncompressed file, libtiff's planes unpacked
    with the raw mode that Pillow gives libtiff otherwise."""
    if tif.photo == 6 and tif.compression != 1:
        if tif.spp != 3:
            tif.fail(f"YCbCr TIFF of {tif.spp} samples (libtiff refuses "
                     "it, and so Pillow does)")
        if tif.compression != 7:
            if tif.orientation != 1:
                tif.fail("YCbCr TIFF with an orientation, compressed other "
                         "than with JPEG, is not supported for Pillow's "
                         "reader")
            return _tiff_ycbcr(tif)
    if tif.compression == 1:
        return _tiff_pillow_raw(tif)
    planes = _tiff_planes(tif)
    if len(planes) == 1:
        return _unpack(tif.lib_rawmode, tif.mode, planes[0], tif.width,
                       tif.name)
    # planar configuration 2, checked against Pillow 12.1.0 for these
    # modes alone: 8- or 16-bit planes (by their high bytes) stacked
    if (tif.bps[0] not in (8, 16) or tif.spp != len(tif.mode)
            or not (tif.mode in ("RGB", "CMYK")
                    or (tif.mode == "RGBA" and tif.extra == (2,)))):
        tif.fail(f"compressed planar TIFF of mode {tif.mode}, extra samples "
                 f"{tif.extra} and {tif.bps[0]}-bit samples is not supported")
    if tif.bps[0] == 16:
        planes = [(p.view("<u2") >> 8).astype(np.uint8) for p in planes]
    return np.stack([p[:, :tif.width] for p in planes], -1)


def _oriented(tif: _Tiff, img: np.ndarray) -> np.ndarray:
    """Pillow's ``ImageOps.exif_transpose``, which ``TiffImageFile``
    applies on load, for the Orientation tag (274)."""
    o = tif.orientation
    if o == 2:
        img = img[:, ::-1]
    elif o == 3:
        img = img[::-1, ::-1]
    elif o == 4:
        img = img[::-1]
    elif o == 5:
        img = img.swapaxes(0, 1)
    elif o == 6:
        img = img.swapaxes(0, 1)[:, ::-1]
    elif o == 7:
        img = img.swapaxes(0, 1)[::-1, ::-1]
    elif o == 8:
        img = img.swapaxes(0, 1)[::-1]
    return np.ascontiguousarray(img)


def _pillow_cmyk(c: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb``: (255 - k) - MULDIV255(c, 255 - k)."""
    nk = 255 - k.astype(np.int32)
    t = c.astype(np.int32) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _lut(table: np.ndarray) -> np.ndarray:
    """A colour table [n, 3] as 256 entries, black past its end (what
    Pillow's and OpenCV's lookups give an index the table lacks)."""
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(table), 256)] = table[:256]
    return lut


def _mode_rgb(mode: str, px: np.ndarray, palette=None) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of pixels of ``mode`` (``palette``
    [n, 3] for "P" and "PA")."""
    if mode in ("P", "PA"):
        return _lut(palette)[px[..., 0] if mode == "PA" else px]
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px[..., :3])
    if mode == "CMYK":
        return _pillow_cmyk(px[..., :3], px[..., 3:])
    if mode == "LA":
        px = px[..., 0]
    elif mode == "F":
        px = np.where(px <= 0, 0, np.where(px >= 255, 255,
                                           np.nan_to_num(px))).astype(np.uint8)
    elif mode in ("I", "I;16", "I;16B"):
        px = np.clip(px.astype(np.int64), 0, 255)
    return np.repeat(px.astype(np.uint8)[..., None], 3, -1)


def _mode_raw(mode: str, px: np.ndarray) -> np.ndarray:
    """``np.asarray`` of a Pillow image of ``mode``: mode "1" as the bool
    view of its 0 / 255 bytes, as Pillow's array interface gives it."""
    return np.ascontiguousarray(px, np.uint8).view(bool) if mode == "1" \
        else px


def _tiff_opencv_samples(tif: _Tiff):
    """libtiff's samples of the file as unsigned values [H, W, spp] (16-bit
    ones as uint16), or None where OpenCV 5.0.0's ``imread`` reads
    nothing: more than 4 samples, sample sizes other than 1, 8 and 16 (4
    for a palette), 2-bit and 16-bit palettes, 16-bit CMYK, CMYK with extra
    samples, one-sample YCbCr, tiles in separate planes with fill order 2,
    and the orientations 5-8, which its TIFF decoder refuses."""
    bits, spp, photo = tif.bps[0], tif.spp, tif.photo
    if (tif.tiled and tif.width % tif.tw and bits * spp == 16
            and (tif.planar == 1 or spp == 1)):
        tif.fail("tiled TIFF of 2-byte pixels whose width is not a whole "
                 "number of tiles is not supported for OpenCV's reader "
                 "(imread misplaces the rows of its right-edge tiles)")
    if (spp > 4 or tif.orientation in (5, 6, 7, 8)
            or (tif.tiled and tif.planar == 2 and tif.fill == 2)
            or bits not in ((1, 4, 8) if photo == 3 else (1, 8, 16))
            or (photo == 5 and (bits != 8 or spp != 4))
            or (photo == 6 and spp != 3)):
        return None
    if photo == 6 and tif.compression != 7:
        return _tiff_ycbcr(tif)
    planes = _tiff_planes(tif)
    out = []
    for p in planes:
        n = spp if tif.planar == 1 else 1
        v = (p[:, :2 * n * tif.width].copy().view("<u2") if bits == 16
             else _bit_values(p, n * tif.width, bits))
        out.append(v.reshape(tif.height, tif.width, n))
    return np.concatenate(out, -1)


def _tiff_opencv(tif: _Tiff):
    """What ``cv2.imread(path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)``
    gives as RGB, or None where it reads nothing. OpenCV reads every TIFF
    through libtiff's ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``
    (``grfmt_tiff.cpp``), so its bits are ``tif_getimage.c``'s: grey
    scaled to 8 bits (miniswhite inverted; 16-bit grey by its high byte,
    signed or not), a colour map taken as 8-bit when no entry passes 255
    and shifted right by 8 otherwise, 16-bit colour samples rounded to 8
    bits as (v + 128) // 257 (Pillow takes the high byte), unassociated
    alpha (extra sample 2, or any other value but 0 and 1) premultiplied as
    (c a + 127) // 255 (Pillow drops alpha), associated or unspecified
    alpha kept, CMYK as (255 - k)(255 - c) // 255 (Pillow rounds), YCbCr
    by ``_tiff_ycbcr`` (libjpeg's RGB when JPEG-compressed), grey + alpha
    and palette + alpha without alpha; orientations 2-4 flipped as Pillow
    flips them, but for a tiled file's mirror image, which mirrors each
    column of tiles in place; then alpha dropped."""
    s = _tiff_opencv_samples(tif)
    if s is None:
        return None
    photo, bits = tif.photo, tif.bps[0]
    if photo in (0, 1):
        g = s[..., 0]
        if bits == 16:
            g = g >> 8
        else:
            g = g.astype(np.int32) * (255 // ((1 << bits) - 1))
        if photo == 0:
            g = 255 - g
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    elif photo == 3:
        cmap = tif.cmap
        rgb = _lut(cmap >> 8 if cmap.max(initial=0) >= 256 else cmap)[
            s[..., 0]]
    elif photo == 5:
        c, k = s[..., :3].astype(np.int32), s[..., 3:].astype(np.int32)
        rgb = ((255 - k) * (255 - c) // 255).astype(np.uint8)
    else:                                   # RGB, or YCbCr from libjpeg
        v = s.astype(np.int64)
        if bits == 16:
            v = (v + 128) // 257
        rgb = v[..., :3]
        if tif.spp == 4 and tif.extra and tif.extra[0] not in (0, 1):
            rgb = (rgb * v[..., 3:] + 127) // 255
        rgb = rgb.astype(np.uint8)
    o = tif.orientation
    if o in (2, 3):                     # a tiled file's tiles flip in place
        step = tif.tw if tif.tiled else tif.width
        rgb = np.concatenate([rgb[:, x:x + step][:, ::-1]
                              for x in range(0, tif.width, step)], 1)
    if o in (3, 4):
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def decode_tiff(data: bytes, name: str = "<bytes>",
                reader: str = "pillow") -> np.ndarray:
    """The first page of a TIFF -> uint8 [H, W, 3]: "pillow" as
    ``Image.open(...).convert("RGB")`` (the orientation applied), "opencv"
    as the JAX eval's reader (``_tiff_opencv``, else Pillow's)."""
    tif = _Tiff(data, name)
    if reader == "opencv":
        rgb = _tiff_opencv(tif)
        if rgb is not None:
            return rgb
    return _oriented(tif, _mode_rgb(tif.mode, _tiff_pillow_pixels(
        tif.pillow()), tif.palette))


def tiff_raw(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(...))`` of a TIFF's first page."""
    tif = _Tiff(data, name).pillow()
    return _oriented(tif, _mode_raw(tif.mode, _tiff_pillow_pixels(tif)))


# ---------------------------------------------------------------------------
# BMP: Pillow's BmpImagePlugin and OpenCV's grfmt_bmp.cpp, bit for bit
# ---------------------------------------------------------------------------

BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# Pillow's BITFIELDS layouts: (bits, masks) -> raw mode, the letters in the
# order of the pixel's little-endian bytes
BMP_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15"}
_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}


class _Bmp:
    """A BMP's headers as Pillow's ``BmpImageFile._bitmap`` reads them:
    size, mode and raw mode, palette (Pillow ditches a palette of greys
    0..n-1, or black and white, for mode "L" or "1"), the pixels' offset;
    every refusal raised as ``ValueError``."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        try:
            self._parse(data, name)
        except (IndexError, struct.error) as e:
            self.fail(f"truncated or corrupt BMP header ({e})")

    def _parse(self, data: bytes, name: str):
        if data[:2] != b"BM" or len(data) < 18:
            raise ValueError(f"{name}: {_what(data[:8])}")
        offset = struct.unpack("<I", data[10:14])[0]
        hsize = struct.unpack("<I", data[14:18])[0]
        h = data[18:14 + hsize]
        if len(h) < hsize - 4:
            self.fail("truncated BMP header")
        pos = 14 + hsize
        self.hsize = hsize
        self.top_down = False
        masks = None
        if hsize == 12:
            self.width, self.height, _, bits = struct.unpack("<HHHH", h[:8])
            comp, colors, pad = 0, 0, 3
        elif hsize in BMP_HEADERS:
            self.top_down = h[7] == 0xFF
            w, ht, _, bits, comp, _, _, _, colors = struct.unpack(
                "<IIHHIIiiI", h[:32])
            self.width = w
            self.height = 2 ** 32 - ht if self.top_down else ht
            pad = 4
            if comp == 3:
                if len(h) >= 48:
                    n = 4 if len(h) >= 52 else 3
                    masks = list(struct.unpack(f"<{n}I", h[36:36 + 4 * n]))
                else:
                    masks = list(struct.unpack("<3I", data[pos:pos + 12]))
                    pos += 12
                masks = tuple((masks + [0])[:4])
        else:
            self.fail(f"BMP header of {hsize} bytes is not supported")
        if self.width <= 0 or self.height <= 0:
            self.fail(f"BMP of size {self.width} x {self.height}")
        _check_size(self.width, self.height, name)
        self.bits, self.comp, self.masks = bits, comp, masks
        self.colors = colors or (1 << bits if bits < 32 else 0)
        if offset == 14 + hsize and bits <= 8:
            offset += 4 * self.colors
        self.offset = offset
        if bits not in _BMP_BITS:
            self.fail(f"BMP of {bits} bits a pixel is not supported")
        self.mode, self.rawmode = _BMP_BITS[bits]
        if comp == 3:
            key3 = (bits, masks[:3]) if masks else None
            if bits == 32 and (32, masks) in BMP_MASK_MODES:
                self.rawmode = BMP_MASK_MODES[(32, masks)]
                if "A" in self.rawmode:
                    self.mode = "RGBA"
            elif bits in (24, 16) and key3 in BMP_MASK_MODES:
                self.rawmode = BMP_MASK_MODES[key3]
            else:
                self.fail(f"BMP bit fields {masks} of {bits} bits are not "
                          "supported (Pillow does not read them)")
        elif comp in (1, 2):
            if bits != (8 if comp == 1 else 4):
                self.fail(f"BMP RLE{8 if comp == 1 else 4} of {bits} bits a "
                          "pixel is not supported")
        elif comp != 0:
            kinds = {4: "embedded JPEG", 5: "embedded PNG",
                     6: "ALPHABITFIELDS"}
            self.fail(f"BMP compression {comp} ({kinds.get(comp, 'unknown')}"
                      ") is not supported (Pillow does not read it)")
        self.palette = None
        if self.mode == "P":
            if not 0 < self.colors <= 65536:
                self.fail(f"BMP palette of {self.colors} colours")
            raw = np.frombuffer(data[pos:pos + pad * self.colors], np.uint8)
            raw = raw[:len(raw) // pad * pad].reshape(-1, pad)
            rgb = raw[:, 2::-1]
            self.palette = rgb
            want = (np.array([0, 255]) if self.colors == 2
                    else np.arange(self.colors))
            if len(rgb) == self.colors and np.array_equal(
                    rgb, np.repeat(want[:, None], 3, 1)):
                self.mode = self.rawmode = "1" if self.colors == 2 else "L"

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    @property
    def size(self) -> tuple[int, int]:
        return self.width, self.height


def _bmp_unpack(bmp: _Bmp, rows: np.ndarray) -> np.ndarray:
    """Pillow's unpackers of the BMP raw modes over byte rows."""
    raw, W = bmp.rawmode, bmp.width
    if raw in ("P;1", "P;4", "P", "1", "L"):
        return _unpack(raw, "P" if raw.startswith("P") else raw, rows, W,
                       bmp.name)
    if raw in ("BGR;15", "BGR;16"):
        t = rows[:, :2 * W].copy().view("<u2").astype(np.int32)
        if raw == "BGR;15":
            c = [(t >> 10) & 31, (t >> 5) & 31, t & 31]
            top = (31, 31, 31)
        else:
            c = [(t >> 11) & 31, (t >> 5) & 63, t & 31]
            top = (31, 63, 31)
        return np.stack([v * 255 // m for v, m in zip(c, top)], -1).astype(
            np.uint8)
    k = len(raw)
    px = rows[:, :k * W].reshape(rows.shape[0], W, k)
    order = [raw.index(c) for c in ("RGBA" if bmp.mode == "RGBA" else "RGB")]
    return np.ascontiguousarray(px[..., order])


def bmp_rle_numpy(data: bytes, start: int, bits: int, width: int,
                  height: int, pillow: bool):
    """RLE8 (``bits`` 8) or RLE4 from ``data[start:]`` -> (status, palette
    indices [height, width] in file row order, the bottom row first).
    ``pillow``: Pillow's ``BmpRleDecoder``, which appends pixels to one
    buffer: a run is cut at its row's end, an end of line pads the row
    with index 0, a delta reads two bytes and then (dx, dy) from the next
    two and pads with index 0, an RLE4 absolute run of n reads n // 2
    bytes, absolute runs align to even file offsets; status 1 when the
    data ends short of the image. Otherwise OpenCV's ``BmpDecoder``:
    pixels placed at a position that an end of line, a delta or the end
    of bitmap moves (the skipped ones keep index 0); status 2 for a run
    past its row's end (``imread`` stops there), 1 when the data ends
    before the end of bitmap."""
    n, size = len(data), width * height
    i = start
    if pillow:
        out, x = bytearray(), 0
        while len(out) < size:
            if i + 2 > n:
                break
            count, byte = data[i], data[i + 1]
            i += 2
            if count:
                count = min(count, max(0, width - x))
                out += bytes(byte if bits == 8 else (
                    byte & 15 if k % 2 else byte >> 4) for k in range(count))
                x += count
            elif byte == 0:
                out += bytes(-len(out) % width)
                x = 0
            elif byte == 1:
                break
            elif byte == 2:
                if i + 4 > n:
                    return 1, None
                right, up = data[i + 2], data[i + 3]
                i += 4
                out += bytes(right + up * width)
                x = len(out) % width
            else:
                take = byte // 2 if bits == 4 else byte
                got = data[i:i + take]
                i += len(got)
                out += (bytes(v for b in got for v in (b >> 4, b & 15))
                        if bits == 4 else got)
                if len(got) < take:
                    break
                x += byte
                i += i % 2
        if len(out) < size:
            return 1, None
        return 0, np.frombuffer(bytes(out[:size]), np.uint8).reshape(
            height, width)
    out = np.zeros(size, np.uint8)
    x = y = 0
    while y < height:
        if i + 2 > n:
            return 1, None
        count, code = data[i], data[i + 1]
        i += 2
        if count:
            if x + count > width:
                return 2, None
            out[y * width + x:y * width + x + count] = [
                code if bits == 8 else (code & 15 if k % 2 else code >> 4)
                for k in range(count)]
            x += count
        elif code == 0:
            x, y = 0, y + 1
        elif code == 1:
            break
        elif code == 2:
            if i + 2 > n:
                return 1, None
            y, x = divmod(y * width + x + data[i] + data[i + 1] * width,
                          width)
            i += 2
        else:
            nb = code if bits == 8 else (code + 1) // 2
            if x + code > width:
                return 2, None
            if i + nb > n:
                return 1, None
            b = np.frombuffer(data[i:i + nb], np.uint8)
            if bits == 4:
                b = np.stack([b >> 4, b & 15], 1).reshape(-1)[:code]
            out[y * width + x:y * width + x + code] = b
            x += code
            i += nb + nb % 2
    return 0, out.reshape(height, width)


def bmp_rle(data: bytes, start: int, bits: int, width: int, height: int,
            pillow: bool):
    """``bmp_rle_numpy`` through the C++ helper when it builds."""
    lib = _raster()
    if lib is None:
        return bmp_rle_numpy(data, start, bits, width, height, pillow)
    out = np.empty((height, width), np.uint8)
    status = lib.bmp_rle_decode(data, len(data), start, bits, width, height,
                                int(pillow), out)
    return status, (out if status == 0 else None)


def _bmp_pillow_pixels(bmp: _Bmp) -> np.ndarray:
    """Pillow's pixels of the BMP's mode, top row first."""
    W, H = bmp.width, bmp.height
    if bmp.comp in (1, 2):
        if bmp.mode not in ("P", "L"):
            bmp.fail(f"BMP RLE of mode {bmp.mode} is not supported (Pillow "
                     "has no unpacker for it)")
        status, px = bmp_rle(bmp.data, bmp.offset, bmp.bits, W, H, True)
        if status:
            bmp.fail("truncated BMP RLE data (not enough image data)")
    elif (bmp.rawmode == bmp.mode in ("L", "P")
          and bmp.offset + H * _bmp_stride(bmp) <= len(bmp.data)):
        # Pillow maps such a file (``ImageFile.load``'s mmap path): row r
        # is the W bytes at offset + r * stride, even where the rows
        # overlap (an "L" file of 4-bit samples); past the file's end the
        # mapped page reads 0
        stride = _bmp_stride(bmp)
        buf = np.frombuffer(bmp.data[bmp.offset:] + bytes(W), np.uint8)
        px = np.stack([buf[r * stride:r * stride + W] for r in range(H)])
    else:
        buf = _raw_rows(bmp.data, bmp.offset, H, (W * _rawmode_bits(
            bmp.rawmode) + 7) // 8, _bmp_stride(bmp),
            lambda m: bmp.fail("BMP: " + m))
        px = _bmp_unpack(bmp, buf)
    return px if bmp.top_down else px[::-1]


def _bmp_stride(bmp: _Bmp) -> int:
    return ((bmp.width * bmp.bits + 31) >> 3) & ~3


def _bmp_opencv(bmp: _Bmp):
    """``cv2.imread``'s BMP decoder (``grfmt_bmp.cpp``) as RGB, or None
    where it reads nothing: palette indices looked up in the palette as
    stored (its missing entries black; Pillow reads a palette of greys
    0..n-1 as mode "L"), 16-bit pixels shifted to 8 bits (5-5-5, or 5-6-5
    for the BITFIELDS masks 0xF800, 0x7E0, 0x1F: b = t << 3 & 0xF8 ...,
    where Pillow scales by 255 / 31 and 255 / 63; None for 16-bit
    BITFIELDS in a header of 52 bytes or more), RLE as
    ``bmp_rle_numpy``'s OpenCV branch (None for a run past its row's end,
    data that ends before the end of bitmap, or RLE4 data shorter than 2
    bytes a row + 2); 24 and 32 bits as Pillow reads them."""
    W, H = bmp.width, bmp.height
    if bmp.comp == 3 and bmp.bits == 16 and bmp.hsize >= 52:
        return None
    if bmp.comp in (1, 2):
        if bmp.comp == 2 and len(bmp.data) - bmp.offset < 2 * H + 2:
            return None
        status, px = bmp_rle(bmp.data, bmp.offset, bmp.bits, W, H, False)
        if status:
            return None
        px = px[::-1]
    elif bmp.bits <= 8 or bmp.bits == 16:
        stride = ((W * bmp.bits + 31) >> 3) & ~3
        buf = np.frombuffer(bmp.data[bmp.offset:bmp.offset + H * stride],
                            np.uint8)
        if buf.size < H * stride:
            bmp.fail("truncated BMP pixel data")
        rows = buf.reshape(H, stride)
        if bmp.bits == 16:
            t = rows[:, :2 * W].copy().view("<u2").astype(np.int32)
            if bmp.rawmode == "BGR;16":
                rgb = [(t >> 8) & 0xF8, (t >> 3) & 0xFC, (t << 3) & 0xF8]
            else:
                rgb = [(t >> 7) & 0xF8, (t >> 2) & 0xF8, (t << 3) & 0xF8]
            px = np.stack(rgb, -1).astype(np.uint8)
        else:
            px = _unpack({1: "P;1", 4: "P;4", 8: "P"}[bmp.bits], "P", rows,
                         W, bmp.name)
        px = px if bmp.top_down else px[::-1]
    else:
        return _mode_rgb(bmp.mode, _bmp_pillow_pixels(bmp))
    return np.ascontiguousarray(px) if px.ndim == 3 else _lut(
        bmp.palette)[px]


def decode_bmp(data: bytes, name: str = "<bytes>",
               reader: str = "pillow") -> np.ndarray:
    """A BMP -> uint8 [H, W, 3]: "pillow" as ``Image.open(...).convert(
    "RGB")``, "opencv" as ``cv2.imread`` (``_bmp_opencv``)."""
    bmp = _Bmp(data, name)
    if reader == "opencv":
        rgb = _bmp_opencv(bmp)
        if rgb is not None:
            return rgb
    return _mode_rgb(bmp.mode, _bmp_pillow_pixels(bmp), bmp.palette)


def bmp_raw(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(...))`` of a BMP."""
    bmp = _Bmp(data, name)
    return _mode_raw(bmp.mode, _bmp_pillow_pixels(bmp))


# ---------------------------------------------------------------------------
# GIF: the first frame as Pillow's GifImagePlugin and OpenCV's grfmt_gif.cpp
# read it
# ---------------------------------------------------------------------------


class _Gif:
    """A GIF's screen and first image as Pillow's ``GifImageFile._seek(0)``
    reads them: the size (the screen, grown to hold the image), the image's
    extent, interlacing, LZW minimum code size and data, the colour tables
    (a table of the greys 0..n-1 counts as none, so the mode is "L"), the
    background and transparent indices."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        try:
            self._parse(data, name)
        except (IndexError, struct.error) as e:
            self.fail(f"truncated or corrupt GIF header ({e})")

    def _parse(self, data: bytes, name: str):
        if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
            raise ValueError(f"{name}: {_what(data[:8])}")
        W, H, flags, self.background = struct.unpack("<HHBB", data[6:12])
        pos = 13
        self.global_table = None
        if flags & 128:
            n = 3 << ((flags & 7) + 1)
            self.global_table = np.frombuffer(data[pos:pos + n],
                                              np.uint8).reshape(-1, 3)
            pos += n
        self.transparent = None
        while True:
            if pos >= len(data) or data[pos:pos + 1] == b";":
                self.fail("GIF without an image")
            tag = data[pos]
            pos += 1
            if tag == 0x21:                         # extension
                label = data[pos]
                pos += 1
                first = True
                while pos < len(data) and data[pos]:
                    block = data[pos + 1:pos + 1 + data[pos]]
                    if label == 0xF9 and first and block[0] & 1:
                        self.transparent = block[3]
                    first = False
                    pos += 1 + data[pos]
                pos += 1
            elif tag == 0x2C:                       # image descriptor
                x0, y0, w, h, f = struct.unpack("<HHHHB", data[pos:pos + 9])
                pos += 9
                self.extent = (x0, y0, x0 + w, y0 + h)
                self.interlace = bool(f & 64)
                self.local_table = None
                if f & 128:
                    n = 3 << ((f & 7) + 1)
                    self.local_table = np.frombuffer(
                        data[pos:pos + n], np.uint8).reshape(-1, 3)
                    pos += n
                self.min_bits = data[pos]
                self.start = pos + 1
                break
            else:
                self.fail(f"corrupt GIF (block 0x{tag:02X})")
        self.screen = (W, H)
        self.width = max(W, self.extent[2])
        self.height = max(H, self.extent[3])
        _check_size(self.width, self.height, name)
        self.palette = None
        if self.local_table is not None:
            if _palette_needed(self.local_table):
                self.palette = self.local_table
        elif self.global_table is not None and _palette_needed(
                self.global_table):
            self.palette = self.global_table
        self.mode = "P" if self.palette is not None else "L"

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    @property
    def size(self) -> tuple[int, int]:
        return self.width, self.height

    def indices(self) -> np.ndarray:
        """The first image's LZW data decoded, rows put in order ->
        [h, w] uint8."""
        x0, y0, x1, y1 = self.extent
        w, h = x1 - x0, y1 - y0
        if not 1 <= self.min_bits <= 11:
            self.fail(f"GIF LZW minimum code size {self.min_bits}")
        chunks, pos, data = [], self.start, self.data
        while pos < len(data) and data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        px = np.frombuffer(lzw_decode(b"".join(chunks), w * h, self.name,
                                      lsb=True, symbol_bits=self.min_bits),
                           np.uint8)
        if px.size < w * h:
            self.fail("truncated GIF image data")
        px = px.reshape(h, w)
        if self.interlace:
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                    np.arange(2, h, 4), np.arange(1, h, 2)])
            out = np.empty_like(px)
            out[order] = px
            px = out
        return px


def _palette_needed(table: np.ndarray) -> bool:
    """Pillow's ``_is_palette_needed``: not the greys 0, 1, 2, ..."""
    return not np.array_equal(table, np.repeat(np.arange(len(table))[:, None],
                                               3, 1))


def _gif_pillow_pixels(gif: _Gif) -> np.ndarray:
    """Pillow's first frame: the screen filled with the transparent index
    (else 0), the image's indices put at its extent."""
    fill = gif.transparent if gif.transparent is not None else 0
    img = np.full((gif.height, gif.width), fill, np.uint8)
    x0, y0, x1, y1 = gif.extent
    img[y0:y1, x0:x1] = gif.indices()
    return img


def _gif_opencv(gif: _Gif):
    """``cv2.imread``'s GIF decoder (OpenCV 5.0.0) as RGB, or None where it
    reads nothing: a canvas of the screen's size in the global table's
    background colour (black without a global table), the first image's
    colours (local table, else global) put at its extent, its transparent
    pixels leaving the canvas (Pillow shows the colour of the transparent
    index there, and colour 0 or the transparent one around a smaller
    image). None for a background index past the global table or an index
    past the image's table."""
    table = gif.local_table if gif.local_table is not None else \
        gif.global_table
    if table is None:
        gif.fail("GIF without a colour table is not supported for OpenCV's "
                 "reader")
    W, H = gif.screen
    x0, y0, x1, y1 = gif.extent
    if x1 > W or y1 > H:
        gif.fail("GIF image outside its screen is not supported for "
                 "OpenCV's reader")
    if gif.global_table is not None and gif.background >= len(
            gif.global_table):
        return None
    px = gif.indices()
    if px.max(initial=0) >= len(table):
        return None
    bg = (gif.global_table[gif.background] if gif.global_table is not None
          else np.zeros(3, np.uint8))
    canvas = np.empty((H, W, 3), np.uint8)
    canvas[:] = bg
    rgb = _lut(table)[px]
    if gif.transparent is not None:
        keep = px == gif.transparent
        rgb[keep] = canvas[y0:y1, x0:x1][keep]
    canvas[y0:y1, x0:x1] = rgb
    return canvas


def decode_gif(data: bytes, name: str = "<bytes>",
               reader: str = "pillow") -> np.ndarray:
    """A GIF's first frame -> uint8 [H, W, 3]: "pillow" as ``Image.open(
    ...).convert("RGB")`` (mode "P" looked up in the frame's table, zeros
    past its end; mode "L" grey), "opencv" as ``cv2.imread``
    (``_gif_opencv``, else Pillow's)."""
    gif = _Gif(data, name)
    if reader == "opencv":
        rgb = _gif_opencv(gif)
        if rgb is not None:
            return rgb
    px = _gif_pillow_pixels(gif)
    if gif.mode == "P":
        return _lut(gif.palette)[px]
    return np.repeat(px[..., None], 3, -1)


def gif_raw(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(...))`` of a GIF: the first frame's indices
    (mode "P") or greys (mode "L")."""
    return _gif_pillow_pixels(_Gif(data, name))


def _kind(data: bytes, name: str):
    """The plugin Pillow opens the file with (``simple_formats.pillow_open``):
    "jpeg", "png", "tiff", "bmp", "gif" or "webp", a ``simple_formats.Pic``,
    or "other" where no plugin takes it; a file that makes ``Image.open``
    raise raises ``ValueError`` naming it."""
    got = simple_formats.pillow_open(data, name)
    return "other" if got is None else got


def read_rgb(path: str | Path, reader: str = "pillow") -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3]: a JPEG, PNG, TIFF,
    BMP, GIF, WebP or one of the simple formats, told apart by their first
    bytes, as both readers do (the extension is ignored). ``reader``
    "pillow" gives ``Image.open(path).convert("RGB")`` (the training
    pipeline's reader), "opencv" what the JAX eval's frame reader gives:
    ``cv2.imread(path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)`` as RGB,
    or Pillow's where ``imread`` returns None (the module docstring lists
    where the two differ)."""
    data = Path(path).read_bytes()
    if reader == "opencv":
        rgb = simple_formats.opencv_read(data, str(path))
        if rgb is not None:
            return rgb
    kind = _kind(data, str(path))
    if isinstance(kind, simple_formats.Pic):
        return simple_formats.pic_rgb(kind)
    if kind == "jpeg":
        return decode_jpeg(data, str(path), reader)
    if kind == "tiff":
        return decode_tiff(data, str(path), reader)
    if kind == "bmp":
        return decode_bmp(data, str(path), reader)
    if kind == "gif":
        return decode_gif(data, str(path), reader)
    if kind == "webp":
        return webp.decode_webp(data, str(path), reader)
    if kind == "other":
        raise ValueError(f"{path}: {_what(data[:16])}")
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
