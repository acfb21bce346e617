"""Writes the WebP fixtures under ``sam2_video_tpu_torch/data/fixtures/webp``
from seeds, and their digests:

- ``coverage/``: small files (at most 40 x 40), one per path of the
  port's decoder (``sam2_video_tpu_torch/data/webp.py``): lossy at
  qualities 0, 50 and 100; 1-4 segments; 1, 2, 4 and 8 token partitions;
  the simple filter, the normal filter at sharpness 0 and 7, no filter;
  the sizes 1x1, 1x40 and 17x33; lossy alpha raw and compressed with each
  of the four alpha filters; lossless at methods 0 and 6 and several
  qualities (every transform, the colour cache, meta prefix codes),
  palettes of 2, 4, 16 and 256 colours (each pixel bundling), near-lossless
  and ``exact``; an animation whose first frame lies inside a larger
  canvas, a ``VP8X`` file with an EXIF orientation of 6, ``ICCP`` and
  ``XMP `` chunks, and the ways a file's alpha flags can disagree with
  its chunks;
- ``video/``: a COCO-RLE video dataset of 2 videos x 8 frames of 240x320
  (the JPEG fixtures' frames and annotations) as lossy WebP at quality 80,
  read with ``image_root``;
- ``timing/``: two 240x320 frames each of lossy and lossless WebP, and
  one 1280x1024 frame of each (the EndoVis frame size) of smooth
  synthetic content, with a JPEG of the large frame;
- ``digests.json``: for every file its size (``Image.open(f).size``) and
  the sha256 of Pillow's ``convert("RGB")`` (the JAX loader), of the JAX
  eval's reader (OpenCV's ``imread``, or Pillow where that returns None)
  and of ``np.asarray(Image.open(f))``.

Every image is encoded by the libwebp that Pillow bundles (1.6.0), called
through ``ctypes`` with one thread, so that the files come out the same
bytes every time and the options Pillow does not pass on (segments,
partitions, the filter's type and sharpness, alpha filtering) can be set;
the container of the alpha, animation, EXIF, ICCP and XMP files, and the
``ALPH`` chunks of chosen filters, are written here. ``check_paths``
asserts that each coverage file takes the path it was made for, read by
the port's own parser and numpy decoders (``data/webp.py``).
``tests/test_torch_port_webp.py`` regenerates the files and asks for the
same bytes. To rewrite them: ``python tests/webp_fixtures.py``.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import struct
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WEBP = REPO / "sam2_video_tpu_torch" / "data" / "fixtures" / "webp"
JPEG_VIDEO = WEBP.parent / "jpeg" / "video"
LARGE_HW = (1024, 1280)

# ---------------------------------------------------------------------------
# libwebp through ctypes (encode.h / decode.h of libwebp 1.6.0)
# ---------------------------------------------------------------------------

# WebPConfig, one int (or float) per field, in encode.h's order
CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size",
    "target_PSNR", "segments", "sns_strength", "filter_strength",
    "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
    "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size",
    "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")
FLOAT_FIELDS = ("quality", "target_PSNR")
ENCODER_ABI = 0x0200                 # libwebp checks the major version


class Picture(ctypes.Structure):
    """WebPPicture, with room to spare at the end."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int),
                ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p),
                ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2), ("spare", ctypes.c_uint8 * 256)]


class MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 8)]


_LIB = []


def libwebp() -> ctypes.CDLL:
    """The libwebp that Pillow bundles (``pillow.libs``), loaded after its
    libsharpyuv, which it needs from the global namespace."""
    if not _LIB:
        import PIL

        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                            "pillow.libs")
        ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0],
                    mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
        if lib.WebPGetEncoderVersion() != 0x10600:
            raise RuntimeError("the fixtures are made by libwebp 1.6.0")
        lib.WebPDecodeYUV.restype = ctypes.POINTER(ctypes.c_uint8)
        _LIB.append(lib)
    return _LIB[0]


def encode(img: np.ndarray, **options) -> bytes:
    """uint8 [H, W, 3] or [H, W, 4] -> a WebP file from ``WebPEncode``
    with the default config of quality ``options["quality"]`` (75) and
    ``options`` set on it by name (``CONFIG_FIELDS``), one thread."""
    lib = libwebp()
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    cfg = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(
            options.get("quality", 75.0)), ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    as_float = ctypes.cast(cfg, ctypes.POINTER(ctypes.c_float))
    for key, value in {"thread_level": 0, **options}.items():
        i = CONFIG_FIELDS.index(key)
        if key in FLOAT_FIELDS:
            as_float[i] = float(value)
        else:
            cfg[i] = int(value)
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"invalid WebP config {options}")
    pic = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    pic.width, pic.height = W, H
    pic.use_argb = int(bool(options.get("lossless")))
    importer = lib.WebPPictureImportRGBA if C == 4 else \
        lib.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), img.ctypes.data_as(ctypes.c_void_p),
                    W * C):
        raise RuntimeError("WebPPictureImport failed")
    writer = MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(writer), ctypes.c_void_p)
    try:
        if not lib.WebPEncode(cfg, ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def decode_yuv(data: bytes):
    """libwebp's ``WebPDecodeYUV``: the lossy frame's (Y, U, V) planes,
    [H, W] and [(H + 1) // 2, (W + 1) // 2] uint8."""
    lib = libwebp()
    w, h = ctypes.c_int(), ctypes.c_int()
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    stride, uv_stride = ctypes.c_int(), ctypes.c_int()
    y = lib.WebPDecodeYUV(data, ctypes.c_size_t(len(data)), ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(u), ctypes.byref(v),
                          ctypes.byref(stride), ctypes.byref(uv_stride))
    if not y:
        raise ValueError("WebPDecodeYUV failed")
    H, W, uvh, uvw = h.value, w.value, (h.value + 1) // 2, (w.value + 1) // 2

    def plane(p, rows, cols, s):
        a = np.frombuffer(ctypes.string_at(p, (rows - 1) * s + cols),
                          np.uint8)
        return np.lib.stride_tricks.as_strided(a, (rows, cols),
                                               (s, 1)).copy()
    try:
        return (plane(y, H, W, stride.value), plane(u, uvh, uvw,
                                                    uv_stride.value),
                plane(v, uvh, uvw, uv_stride.value))
    finally:
        lib.WebPFree(y)


# ---------------------------------------------------------------------------
# Content and the container
# ---------------------------------------------------------------------------


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """``raster_fixtures.scene``: a gradient with soft waves, flat blocks
    and a little noise, uint8 [h, w, 3]."""
    import raster_fixtures

    return raster_fixtures.scene(h, w, seed)


def smooth(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth synthetic content, uint8 [h, w, 3]: gradients and slow waves
    under a few flat discs, no noise (a video frame's compressibility)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / max(w - 1, 1) * 180 + 40,
                    yy / max(h - 1, 1) * 160 + 50,
                    128 + 60 * np.sin(xx / 97.0 + yy / 71.0)], -1)
    for _ in range(4):
        cy, cx = g.uniform(0, h), g.uniform(0, w)
        r = g.uniform(0.05, 0.2) * min(h, w)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = g.uniform(0, 255, 3)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def chunk(kind: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return (kind + struct.pack("<I", len(payload)) + payload
            + b"\0" * (len(payload) & 1))


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + le24(width - 1)
                 + le24(height - 1))


def image_chunks(data: bytes) -> list:
    """[(fourcc, payload)] of every chunk of a WebP file."""
    out, pos = [], 12
    while pos < len(data):
        kind, size = data[pos:pos + 4], struct.unpack(
            "<I", data[pos + 4:pos + 8])[0]
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def payload(data: bytes, kind: bytes) -> bytes:
    return next(p for k, p in image_chunks(data) if k == kind)


def alpha_filter(a: np.ndarray, method: int) -> np.ndarray:
    """The forward ALPH filter (0 none, 1 horizontal, 2 vertical, 3
    gradient) whose inverse ``webp.alpha_unfilter_numpy`` is."""
    a = a.astype(np.int64)
    H, W = a.shape
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method == 0:
        return a.astype(np.uint8)
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph(a: np.ndarray, method: int, compressed: bool,
         preprocessing: int = 0) -> bytes:
    """An ``ALPH`` chunk of the plane ``a``: its header byte, then the
    filtered plane raw or as the green of a lossless image stream (a VP8L
    file's payload past its 5-byte header)."""
    f = alpha_filter(a, method)
    head = bytes([int(compressed) | method << 2 | preprocessing << 4])
    if not compressed:
        return chunk(b"ALPH", head + f.tobytes())
    green = np.zeros(f.shape + (3,), np.uint8)
    green[..., 1] = f
    stream = payload(encode(green, lossless=1, quality=100, method=4),
                     b"VP8L")[5:]
    return chunk(b"ALPH", head + stream)


def anmf(x: int, y: int, frame: bytes) -> bytes:
    """An ``ANMF`` chunk placing the simple or extended file ``frame``'s
    image (and alpha) chunks at (x, y), both even, for 100 ms, blended,
    not disposed."""
    from sam2_video_tpu_torch.data import webp

    f = webp.WebPFile(frame, "frame").frame
    chunks = [(k, p) for k, p in image_chunks(frame)
              if k in (b"ALPH", b"VP8 ", b"VP8L")]
    return chunk(b"ANMF", le24(x // 2) + le24(y // 2) + le24(f.width - 1)
                 + le24(f.height - 1) + le24(100) + b"\0"
                 + b"".join(chunk(k, p) for k, p in chunks))


def set_alpha_bit(data: bytes) -> bytes:
    """A simple VP8L file with its header's ``alpha_is_used`` bit set."""
    out = bytearray(data)
    out[24] |= 0x10
    return bytes(out)


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------

RED_BGRA = bytes([0, 0, 255, 255])     # an ANIM background colour
VP8X_ALPHA, VP8X_ANIMATION, VP8X_EXIF, VP8X_ICCP, VP8X_XMP = \
    0x10, 0x02, 0x08, 0x20, 0x04


def _exif_orientation(value: int) -> bytes:
    """A little-endian TIFF header with one IFD entry: Orientation."""
    return (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, value, 0)
            + struct.pack("<I", 0))


def _alpha_plane(h: int, w: int, seed: int) -> np.ndarray:
    """A ramp with a transparent disc and a few noisy rows."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = (xx * 255 // max(w - 1, 1) + yy * 3) % 256
    a[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (min(h, w) // 4) ** 2] = 0
    a[max(h - 3, 0):] = g.integers(0, 256, (min(3, h), w))
    return a.astype(np.uint8)


def _mixed(h: int, w: int, seed: int) -> np.ndarray:
    """Noise, a repeated tile, a scene and posterised quarters: enough
    variety for the lossless encoder's colour cache and meta prefix
    codes at 40 x 40."""
    g = np.random.default_rng(seed)
    img = scene(h, w, seed).copy()
    img[:h // 2, :w // 2] = g.integers(0, 256, (h // 2, w // 2, 3))
    img[h // 2:, w // 2:] = img[h // 2:, w // 2:] // 64 * 64
    tile = g.integers(0, 256, (4, 4, 3))
    img[:h // 2, w // 2:] = np.tile(tile, (h // 8 + 1, w // 8 + 1, 1))[
        :h // 2, :w - w // 2]
    return img


def _palette_image(n: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    pal = g.integers(0, 256, (n, 3))
    return pal[g.integers(0, n, (40, 40))].astype(np.uint8)


def _lossy_alpha(name_seed: int, method: int, compressed: bool,
                 preprocessing: int = 0) -> bytes:
    rgb = scene(40, 40, name_seed)
    a = _alpha_plane(40, 40, name_seed)
    return riff(vp8x(VP8X_ALPHA, 40, 40),
                alph(a, method, compressed, preprocessing),
                chunk(b"VP8 ", payload(encode(rgb, quality=70), b"VP8 ")))


def coverage() -> dict:
    """{name: bytes} of the coverage files; ``check_paths`` says which path
    each takes."""
    sc = scene(40, 40, 0)
    g = np.random.default_rng(11)
    noise = g.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    dot = np.full((40, 40, 3), 77, np.uint8)
    dot[3:9, 30:37] = (250, 10, 90)
    out = {f"lossy_q{q}.webp": encode(sc, quality=q) for q in (0, 50, 100)}
    for k in (1, 2, 3, 4):
        out[f"lossy_segments{k}.webp"] = encode(sc, quality=60, segments=k,
                                                sns_strength=100)
    for log in range(4):
        out[f"lossy_partitions{1 << log}.webp"] = encode(
            sc, quality=60, method=2, partitions=log)
    out.update({
        "lossy_filter_simple.webp": encode(sc, quality=40, filter_type=0),
        "lossy_filter_sharpness0.webp": encode(sc, quality=40,
                                               filter_sharpness=0),
        "lossy_filter_sharpness7.webp": encode(sc, quality=40,
                                               filter_sharpness=7),
        "lossy_filter_off.webp": encode(sc, quality=40, filter_strength=0),
        "lossy_1x1.webp": encode(sc[:1, :1], quality=80),
        "lossy_1x40.webp": encode(sc[:, :1], quality=80),
        "lossy_40x1.webp": encode(sc[:1], quality=80),
        "lossy_17x33.webp": encode(scene(33, 17, 3), quality=80),
        "lossy_noise_q5.webp": encode(noise, quality=5),
        "lossy_noise_q95.webp": encode(noise, quality=95),
        "lossy_skip.webp": encode(dot, quality=50, method=1),
    })
    for f in range(4):
        out[f"alpha_raw_filter{f}.webp"] = _lossy_alpha(f, f, False)
        out[f"alpha_vp8l_filter{f}.webp"] = _lossy_alpha(4 + f, f, True)
    out["alpha_preprocessed.webp"] = _lossy_alpha(8, 1, True, 1)
    rgba = np.dstack([scene(40, 40, 9), _alpha_plane(40, 40, 9)])
    out["alpha_libwebp_q100.webp"] = encode(rgba, quality=60)
    out["alpha_libwebp_q30.webp"] = encode(rgba, quality=60,
                                           alpha_quality=30,
                                           alpha_filtering=2)
    mixed = _mixed(40, 40, 5)
    out.update({
        "lossless_m0_q0.webp": encode(sc, lossless=1, method=0, quality=0),
        "lossless_m4_q75.webp": encode(sc, lossless=1, method=4,
                                       quality=75),
        "lossless_m6_q100.webp": encode(sc, lossless=1, method=6,
                                        quality=100),
        "lossless_mixed_m2.webp": encode(mixed, lossless=1, method=2,
                                         quality=50),
        "lossless_mixed_m4.webp": encode(mixed, lossless=1, method=4,
                                         quality=75),
        "lossless_mixed_m6.webp": encode(mixed, lossless=1, method=6,
                                         quality=100),
        "lossless_near60.webp": encode(sc, lossless=1, near_lossless=60),
        "lossless_rgba.webp": encode(rgba, lossless=1),
        "lossless_rgba_exact.webp": encode(rgba, lossless=1, exact=1),
    })
    for n in (2, 4, 16, 256):
        out[f"lossless_palette{n}.webp"] = encode(_palette_image(n, n),
                                                  lossless=1)
    opaque = encode(scene(20, 30, 12), lossless=1)
    out["lossless_alpha_bit_set.webp"] = set_alpha_bit(opaque)
    out["vp8x_alpha_flag_vp8l_opaque.webp"] = riff(
        vp8x(VP8X_ALPHA, 30, 20), chunk(b"VP8L", payload(opaque, b"VP8L")))
    out["vp8x_alpha_flag_without_alph.webp"] = riff(
        vp8x(VP8X_ALPHA, 40, 40),
        chunk(b"VP8 ", payload(encode(sc, quality=70), b"VP8 ")))
    out["vp8x_alph_without_flag.webp"] = riff(
        vp8x(0, 40, 40), alph(_alpha_plane(40, 40, 13), 2, True),
        chunk(b"VP8 ", payload(encode(sc, quality=70), b"VP8 ")))
    first = encode(scene(45, 61, 14), quality=70)
    out["anim_offset.webp"] = riff(
        vp8x(VP8X_ANIMATION, 80, 60), chunk(b"ANIM", RED_BGRA + b"\0\0"),
        anmf(4, 6, first), anmf(0, 0, encode(scene(60, 80, 15),
                                             quality=70)))
    frames = [encode(np.dstack([scene(20, 30, 16 + i),
                                _alpha_plane(20, 30, 16 + i)]), lossless=1)
              for i in range(3)]
    out["anim_lossless_alpha.webp"] = riff(
        vp8x(VP8X_ANIMATION | VP8X_ALPHA, 30, 20),
        chunk(b"ANIM", RED_BGRA + b"\0\0"), *[anmf(0, 0, f) for f in frames])
    out["anim_lossy_alph_offset.webp"] = riff(
        vp8x(VP8X_ANIMATION | VP8X_ALPHA, 40, 40),
        chunk(b"ANIM", bytes(4) + b"\1\0"),
        anmf(2, 4, encode(np.dstack([scene(31, 37, 19),
                                     _alpha_plane(31, 37, 19)]),
                          quality=60)),
        anmf(0, 0, encode(scene(40, 40, 20), quality=60)))
    out["exif_orientation6.webp"] = riff(
        vp8x(VP8X_EXIF, 17, 33),
        chunk(b"VP8 ", payload(encode(scene(33, 17, 21), quality=75),
                               b"VP8 ")),
        chunk(b"EXIF", _exif_orientation(6)))
    out["iccp_xmp.webp"] = riff(
        vp8x(VP8X_ICCP | VP8X_XMP, 23, 17),
        chunk(b"ICCP", b"not a real profile"),
        chunk(b"VP8L", payload(encode(scene(17, 23, 22), lossless=1),
                               b"VP8L")),
        chunk(b"XMP ", b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"))
    return out


def _vp8_info(data: bytes) -> dict:
    from sam2_video_tpu_torch.data import webp

    info: dict = {}
    webp.vp8_decode_numpy(webp.WebPFile(data, "f").frame.vp8, "f", info)
    return info


def _vp8l_info(vp8l: bytes, size=None) -> dict:
    from sam2_video_tpu_torch.data import webp

    info: dict = {}
    webp.vp8l_decode_numpy(vp8l, *(size or (None, None)), info=info)
    return info


def check_paths(files: dict) -> None:
    """Asserts that each coverage file takes the path it was made for,
    read from its headers by the port's parser (``data/webp.py``)."""
    from sam2_video_tpu_torch.data import webp

    def vp8(name):
        return _vp8_info(files[name])

    def vp8l(name):
        return _vp8l_info(webp.WebPFile(files[name], name).frame.vp8l)

    for k in (1, 2, 3, 4):
        assert vp8(f"lossy_segments{k}.webp")["segments"] == list(range(k))
    assert not vp8("lossy_segments1.webp")["update_map"]
    for n in (1, 2, 4, 8):
        assert vp8(f"lossy_partitions{n}.webp")["partitions"] == n
    simple = vp8("lossy_filter_simple.webp")
    assert simple["filter_type"] == 1 and simple["level"] > 0
    for s in (0, 7):
        i = vp8(f"lossy_filter_sharpness{s}.webp")
        assert (i["filter_type"], i["sharpness"]) == (2, s)
    assert vp8("lossy_filter_off.webp")["filter_type"] == 0
    noise = vp8("lossy_noise_q5.webp")
    assert noise["i4x4"] and noise["i16"]
    skip = vp8("lossy_skip.webp")
    assert skip["skip_proba"] and skip["skipped"] and skip["filter_type"]
    for name, method, compressed, pre in (
            [(f"alpha_raw_filter{f}.webp", f, 0, 0) for f in range(4)]
            + [(f"alpha_vp8l_filter{f}.webp", f, 1, 0) for f in range(4)]
            + [("alpha_preprocessed.webp", 1, 1, 1)]):
        alph_chunk = webp.WebPFile(files[name], name).frame.alph
        assert alph_chunk[0] == compressed | method << 2 | pre << 4, name
    transforms, cache, meta, bits = set(), False, False, set()
    for name in files:
        if name.startswith("lossless_"):
            i = vp8l(name)
            transforms |= set(i.get("transforms", ()))
            cache |= bool(i.get("cache_bits"))
            meta |= bool(i.get("meta_codes"))
            bits |= set(i.get("palette_bits", ()))
            assert i.get("simple_codes") and i.get("normal_codes"), name
    assert transforms == {0, 1, 2, 3} and cache and meta, (transforms, cache,
                                                           meta)
    assert bits == {0, 1, 2, 3}
    for n, b in ((2, 3), (4, 2), (16, 1), (256, 0)):
        assert vp8l(f"lossless_palette{n}.webp")["palette_bits"] == [b]
    alph_stream = webp.WebPFile(files["alpha_vp8l_filter1.webp"], "a")
    assert _vp8l_info(alph_stream.frame.alph[1:], (40, 40))
    assert webp.WebPFile(files["lossless_alpha_bit_set.webp"], "b").has_alpha
    assert not webp.WebPFile(files["vp8x_alpha_flag_vp8l_opaque.webp"],
                             "c").has_alpha
    for name in ("vp8x_alph_without_flag.webp",
                 "vp8x_alpha_flag_without_alph.webp"):
        assert webp.WebPFile(files[name], name).has_alpha
    anim = webp.WebPFile(files["anim_offset.webp"], "e")
    assert (anim.canvas, anim.frames, anim.frame.x, anim.frame.y,
            anim.frame.width, anim.frame.height) == ((80, 60), 2, 4, 6, 61,
                                                     45)
    assert webp.WebPFile(files["anim_lossless_alpha.webp"], "f").frames == 3
    assert b"EXIF" in files["exif_orientation6.webp"]


def video_dataset(root: Path) -> None:
    """The JPEG fixtures' video dataset (2 x 8 frames of 240x320, the same
    annotations) with each frame as lossy WebP at quality 80."""
    import raster_fixtures

    frames, ann = raster_fixtures._video_frames()
    (root / "images").mkdir(parents=True, exist_ok=True)
    for im in ann["images"]:
        rgb = frames[im["file_name"]]
        im["file_name"] = im["file_name"].replace(".jpg", ".webp")
        (root / "images" / im["file_name"]).write_bytes(encode(rgb,
                                                               quality=80))
    (root / "annotations.json").write_text(json.dumps(ann))


def timing_frames() -> dict:
    """Two 240x320 video frames each as lossy (quality 80) and lossless
    WebP, and one 1280x1024 frame of smooth content of each and as a
    baseline JPEG (Pillow, quality 90: the same pixels in the format most
    frames come in, for the decode times)."""
    import raster_fixtures

    frames, _ = raster_fixtures._video_frames()
    out = {}
    for i, name in enumerate(sorted(frames)[::8]):
        out[f"lossy_{i}.webp"] = encode(frames[name], quality=80)
        out[f"lossless_{i}.webp"] = encode(frames[name], lossless=1)
    large = smooth(*LARGE_HW, seed=0)
    out["large_lossy.webp"] = encode(large, quality=80)
    out["large_lossless.webp"] = encode(large, lossless=1)
    out["large.jpg"] = raster_fixtures._pillow(large, "JPEG", quality=90)
    return out


def generate(root: Path = WEBP) -> None:
    """Writes the WebP fixtures and their digests under ``root``."""
    import raster_fixtures

    root = Path(root)
    files = coverage()
    check_paths(files)
    for sub, content in (("coverage", files), ("timing", timing_frames())):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for name, data in content.items():
            (root / sub / name).write_bytes(data)
    video_dataset(root / "video")
    digests = {p.relative_to(root).as_posix():
               raster_fixtures.file_digests(p)
               for p in sorted(root.rglob("*.webp"))}
    (root / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    generate(Path(sys.argv[1]) if len(sys.argv) > 1 else WEBP)
