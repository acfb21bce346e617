"""Writes the JPEG fixtures under ``sam2_video_tpu_torch/data/fixtures/jpeg``
with Pillow and OpenCV, from seeds, and their digests:

- ``coverage/``: the decoder's cases, one file each: the five samplings
  (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), grey, a restart interval, Huffman
  tables optimised, progressive (4:2:0 and grey), quality 100 on saturated
  colours, the sizes 1x1, 7x9, 37x53 and 17x1000, an EXIF orientation of
  6 (not applied on reading), components named 'R', 'G', 'B' without a
  JFIF marker (RGB, no colour transform), a DC quantiser raised so that
  the IDCT's sums pass +-512 (saturated), and one 480x854 frame, the
  largest;
- ``video/``: a COCO-RLE video dataset of 2 videos x 8 frames of 240x320,
  ``make_synthetic_dataset``'s discs and annotations over a smooth
  gradient, the frames as ``images/*.jpg`` and no ``path`` in
  ``annotations.json`` (read them with ``image_root``);
- ``digests.json``: for every file, the shape and the sha256 of
  ``np.asarray(Image.open(f).convert("RGB"))``, so that a host without
  Pillow can check a decoder bit for bit.

The test ``tests/test_torch_port_jpeg.py`` regenerates them and asks for
the same bytes. To rewrite them: ``python tests/jpeg_fixtures.py``.

It also writes ``sam2_video_tpu_torch/data/fixtures/formats``, the kinds
that neither Pillow nor OpenCV writes, with its own encoder below
(``generate_formats``; ``tests/test_torch_port_formats.py`` regenerates
them): arithmetic-coded JPEG (sequential and progressive, grey, three and
four components, restart intervals, DAC conditioning), lossless JPEG
(predictors 1-7, point transforms, restart intervals, grey, RGB, CMYK,
subsampled), CMYK and YCCK JPEG, 16-bit PNG of the four colour types,
plain and Adam7; a COCO-RLE video of CMYK arithmetic-coded frames
(``video/``), 240x320 frames of each kind for timing (``timing/``), an
EndoVis tree with 16-bit class-id masks (``endovis16/``), and the digests
of what Pillow, OpenCV and ``np.asarray(Image.open(f))`` give for each.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ROOT = REPO / "sam2_video_tpu_torch" / "data" / "fixtures" / "jpeg"
FORMATS = ROOT.parent / "formats"
VIDEOS, FRAMES, VIDEO_HW, CATEGORIES = 2, 8, (240, 320), 3


def _scene(h: int, w: int, seed: int) -> np.ndarray:
    """A gradient with soft waves, sharp-edged blocks and a little noise:
    every coefficient band in use."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / max(w - 1, 1) * 220 + 20,
                    yy / max(h - 1, 1) * 200 + 30,
                    128 + 90 * np.sin(xx / 5.0 + yy / 7.0)], -1)
    for _ in range(4):
        y0, x0 = g.integers(0, max(h, 1)), g.integers(0, max(w, 1))
        img[y0:y0 + h // 4 + 1, x0:x0 + w // 4 + 1] = g.uniform(0, 255, 3)
    img += g.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2(img: np.ndarray, sampling: int | None = None, quality: int = 85,
         restart: int = 0) -> bytes:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], params)
    assert ok
    return enc.tobytes()


def _rgb_ids(data: bytes) -> bytes:
    """A 4:4:4 Pillow file with its JFIF APP0 segment cut and its
    components renamed 'R', 'G', 'B' (frame and scan headers): libjpeg
    then reads the samples as RGB."""
    d = bytearray(data)
    assert d[2:4] == b"\xff\xe0"
    d = d[:2] + d[4 + ((d[4] << 8) | d[5]):]
    sof, sos = d.index(b"\xff\xc0"), d.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        d[sof + 10 + 3 * k] = cid
        d[sos + 5 + 2 * k] = cid
    return bytes(d)


def _dc_saturate(data: bytes) -> bytes:
    """A flat grey file at quality 100 with the first quantiser entry (DC)
    raised from 1 to 6: the dequantized DC of each block puts the IDCT's
    sums near 700, past the range-limit table's +-512."""
    d = bytearray(data)
    q = d.index(b"\xff\xdb")
    assert d[q + 4] == 0 and d[q + 5] == 1
    d[q + 5] = 6
    return bytes(d)


def coverage_files() -> dict:
    from PIL import Image

    files = {}
    for i, s in enumerate((444, 422, 420, 440, 411)):
        files[f"s{s}.jpg"] = _cv2(_scene(48 + 8 * i, 72 + 5 * i, s), s)
    files["grey.jpg"] = _pillow(_scene(61, 83, 1)[..., 1])
    files["restart.jpg"] = _cv2(_scene(64, 96, 2), 420, restart=3)
    files["optimize.jpg"] = _pillow(_scene(57, 71, 3), optimize=True)
    files["progressive.jpg"] = _pillow(_scene(70, 90, 4), progressive=True)
    files["progressive_grey.jpg"] = _pillow(_scene(45, 50, 5)[..., 0],
                                            progressive=True)
    g = np.random.default_rng(6)
    blocks = (g.integers(0, 2, (6, 8, 3)) * 255).astype(np.uint8)
    sat = blocks.repeat(8, 0).repeat(8, 1)
    sat[::3, ::5] = 255 - sat[::3, ::5]
    files["q100_saturated.jpg"] = _pillow(sat, quality=100)
    for h, w in ((1, 1), (7, 9), (37, 53), (17, 1000)):
        files[f"size_{h}x{w}.jpg"] = _cv2(_scene(h, w, h * w), 420)
    exif = Image.Exif()
    exif[0x0112] = 6
    files["exif_orientation6.jpg"] = _pillow(_scene(40, 64, 7),
                                             exif=exif.tobytes())
    files["rgb_ids.jpg"] = _rgb_ids(_pillow(_scene(33, 41, 8),
                                            subsampling=0))
    files["dc_saturate.jpg"] = _dc_saturate(
        _pillow(np.full((16, 24), 250, np.uint8), quality=100))
    yy, xx = np.mgrid[0:480, 0:854].astype(np.float64)
    large = np.stack([xx / 853 * 200 + 30, yy / 479 * 180 + 40,
                      128 + 80 * np.sin(xx / 37.0)], -1).astype(np.uint8)
    files["large_480x854.jpg"] = _pillow(large, quality=90)
    return files


def video_dataset(root: Path) -> None:
    """``make_synthetic_dataset``'s annotations and discs (its geometry,
    colours and RLEs), each frame's discs painted over a smooth gradient
    and written as a JPEG (Pillow, quality 90, 4:2:0)."""
    from sam2_video_tpu_torch.data import rle
    from sam2_video_tpu_torch.data.synthetic import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data = json.loads(make_synthetic_dataset(
            tmp, num_videos=VIDEOS, frames_per_video=FRAMES,
            image_hw=VIDEO_HW, num_categories=CATEGORIES, seed=0).read_text())
    h, w = VIDEO_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    (root / "images").mkdir(parents=True, exist_ok=True)
    by_image = {}
    for a in data["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)
    for im in data["images"]:
        v = int(im["file_name"][3])
        frame = np.stack([xx / (w - 1) * 160 + 40 + 20 * v,
                          yy / (h - 1) * 150 + 50,
                          100 + 60 * np.sin((xx + yy) / 41.0)], -1)
        frame = frame.astype(np.uint8)
        for a in by_image.get(im["id"], []):
            colour = np.zeros(3, np.uint8)
            colour[a["category_id"] % 3] = 200
            frame[rle.decode(a["segmentation"]).astype(bool)] = colour
        im["file_name"] = im["file_name"].replace(".png", ".jpg")
        del im["path"]
        (root / "images" / im["file_name"]).write_bytes(
            _pillow(frame, quality=90))
    (root / "annotations.json").write_text(json.dumps(data))


# ---------------------------------------------------------------------------
# A JPEG encoder for the kinds that no tool here writes: arithmetic coding
# (the QM coder of libjpeg's jcarith.c, sequential SOF9 and progressive
# SOF10), lossless (SOF3, predictors 1-7, point transform) and sequential
# Huffman with any component count (YCCK). Quantised coefficients are made
# once (``quantise``) and written by either entropy coder, so an
# arithmetic-coded file and a Huffman-coded one hold the same values.
# ---------------------------------------------------------------------------

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
# ITU-T T.81 Annex K tables K.1 and K.2, natural order
LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
          14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
          18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
          49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
          99)
CHROMA_Q = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
            24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
            *([99] * 32))
# T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS
# << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin
_D2 = ((0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
       (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
       (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
       (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
       (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
       (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
       (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
       (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
       (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
       (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
       (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
       (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
       (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
       (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
       (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
       (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
       (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
       (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
       (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
       (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
       (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
       (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
       (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
       (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
       (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
       (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
       (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
       (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
       (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
       (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
       (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
       (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
       (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
       (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
       (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
       (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
       (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
ARITAB = tuple(qe << 16 | nmps << 8 | switch << 7 | nlps
               for qe, nlps, nmps, switch in _D2)


def scaled_table(base, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base) * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] /= np.sqrt(2)
    return m


class Coded:
    """A frame's quantised coefficients: ``comps`` (id, h, v, table),
    ``tables`` {table: natural-order values}, ``coefs`` per component
    int64 [blocks down, blocks across, 64] in natural order (the MCU
    padding included), ``apps`` the APPn segments to write."""

    def __init__(self, width, height, comps, tables, coefs, apps=b""):
        self.width, self.height = width, height
        self.comps, self.tables, self.coefs = comps, tables, coefs
        self.apps = apps
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))

    def zigzag(self, ci: int) -> list:
        """Component ``ci``'s blocks as nested lists [down][across][64] in
        zigzag order (made once)."""
        if not hasattr(self, "_zz"):
            self._zz = [c[..., list(ZIGZAG)].tolist() for c in self.coefs]
        return self._zz[ci]

    def comp_blocks(self, ci: int) -> tuple[int, int]:
        """(blocks down, blocks across) of component ``ci`` alone, as a
        non-interleaved scan codes it."""
        _, h, v, _ = self.comps[ci]
        w = -(-self.width * h // self.hmax)
        hgt = -(-self.height * v // self.vmax)
        return -(-hgt // 8), -(-w // 8)


def quantise(planes, sampling, tables, table_of, ids=None,
             apps=b"") -> Coded:
    """Full-size uint8 component planes -> ``Coded``: each component
    averaged down to its sampling factors (``downsample``), padded by edge
    replication to whole MCUs, level-shifted, transformed by the DCT and
    divided by its table (rounded to the nearest integer)."""
    height, width = planes[0].shape
    ids = ids or list(range(1, len(planes) + 1))
    comps = [(ids[i], h, v, table_of[i]) for i, (h, v) in enumerate(sampling)]
    coded = Coded(width, height, comps, {t: np.asarray(q, np.int64)
                                         for t, q in tables.items()}, [],
                  apps)
    m = _dct_matrix()
    for (cid, h, v, tq), p in zip(comps, downsample(planes, sampling)):
        bh, bw = coded.mcuy * v, coded.mcux * h
        p = np.pad(p.astype(np.float64), ((0, 8 * bh - p.shape[0]),
                                          (0, 8 * bw - p.shape[1])),
                   "edge") - 128.0
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = m @ blocks @ m.T
        q = coded.tables[tq].reshape(8, 8)
        coded.coefs.append(np.rint(f / q).astype(np.int64).reshape(bh, bw,
                                                                     64))
    return coded


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _frame(coded: Coded, sof: int, precision: int = 8) -> bytes:
    dqt = b"".join(
        _segment(0xDB, bytes([t]) + bytes(int(q[z]) for z in ZIGZAG))
        for t, q in sorted(coded.tables.items()))
    body = bytes([precision]) + coded.height.to_bytes(2, "big") + \
        coded.width.to_bytes(2, "big") + bytes([len(coded.comps)])
    for cid, h, v, tq in coded.comps:
        body += bytes([cid, h << 4 | v, tq])
    return b"\xff\xd8" + coded.apps + dqt + _segment(sof, body)


def _mcus(coded: Coded, comps):
    """Each MCU of a scan over ``comps``: [(component, block row, block
    column)], in the order the scan codes them."""
    if len(comps) == 1:
        ci = comps[0]
        bh, bw = coded.comp_blocks(ci)
        return [[(ci, by, bx)] for by in range(bh) for bx in range(bw)]
    out = []
    for my in range(coded.mcuy):
        for mx in range(coded.mcux):
            out.append([(ci, my * coded.comps[ci][2] + y,
                         mx * coded.comps[ci][1] + x) for ci in comps
                        for y in range(coded.comps[ci][2])
                        for x in range(coded.comps[ci][1])])
    return out


def _intervals(mcus, restart: int):
    per = restart or len(mcus)
    return [mcus[i:i + per] for i in range(0, len(mcus), per)]


def _scan_data(intervals_bytes) -> bytes:
    """Entropy-coded intervals (already byte-stuffed) joined by RSTn."""
    out = b""
    for i, seg in enumerate(intervals_bytes):
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += seg
    return out


def _sos(coded: Coded, comps, tables, ss, se, ah, al) -> bytes:
    body = bytes([len(comps)])
    for ci in comps:
        body += bytes([coded.comps[ci][0], tables[ci]])
    return _segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


# --- Huffman ---------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def optimal_table(freq) -> tuple[list, list]:
    """libjpeg's ``jpeg_gen_optimal_table``: (counts of code lengths 1-16,
    symbols by length) for the frequencies of 256 symbols, no code of all
    ones."""
    freq = list(freq) + [1]
    size, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [j for n in range(1, 33) for j in range(256) if size[j] == n]
    return bits[1:17], vals


def _codes(counts, vals) -> dict:
    """symbol -> (code, length) of a canonical table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _dht(tc: int, th: int, counts, vals) -> bytes:
    return _segment(0xC4, bytes([tc << 4 | th, *counts, *vals]))


def _category(v: int) -> tuple[int, int]:
    """(size category, the value's bits) of a difference or coefficient."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _huffman_symbols(coded, mcus, tables):
    """The symbols of a sequential Huffman interval: (table key, symbol,
    extra bits value, extra bit count)."""
    pred = {}
    out = []
    for mcu in mcus:
        for ci, by, bx in mcu:
            zz = coded.zigzag(ci)[by][bx]
            t = tables[ci]
            diff = zz[0] - pred.get(ci, 0)
            pred[ci] = zz[0]
            s, bits = _category(diff)
            out.append(((0, t >> 4), s, bits, s))
            run = 0
            last = 63
            while last and not zz[last]:
                last -= 1
            for k in range(1, last + 1):
                if not zz[k]:
                    run += 1
                    continue
                while run > 15:
                    out.append(((1, t & 15), 0xF0, 0, 0))
                    run -= 16
                s, bits = _category(zz[k])
                out.append(((1, t & 15), run << 4 | s, bits, s))
                run = 0
            if last < 63:
                out.append(((1, t & 15), 0, 0, 0))
    return out


def huffman_jpeg(coded: Coded, restart: int = 0, scans=None,
                 sof: int = 0xC1) -> bytes:
    """Sequential Huffman (SOF1 by default, SOF0 when it fits baseline):
    ``scans`` lists each scan's components (one interleaved scan of all by
    default), component i coded with DC and AC table min(i, 1), each
    table optimal for its scan."""
    scans = scans or [list(range(len(coded.comps)))]
    out = _frame(coded, sof)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for comps in scans:
        tables = {ci: 0x11 * min(ci, 1) for ci in comps}
        ivs = [_huffman_symbols(coded, iv, tables)
               for iv in _intervals(_mcus(coded, comps), restart)]
        freq = {}
        for sym in (s for iv in ivs for s in iv):
            freq.setdefault(sym[0], [0] * 256)[sym[1]] += 1
        codes = {}
        for key in sorted(freq):
            counts, vals = optimal_table(freq[key])
            out += _dht(key[0], key[1], counts, vals)
            codes[key] = _codes(counts, vals)
        segs = []
        for iv in ivs:
            w = _BitWriter()
            for key, sym, bits, n in iv:
                w.put(*codes[key][sym])
                if n:
                    w.put(bits, n)
            segs.append(w.flush())
        out += _sos(coded, comps, tables, 0, 63, 0, 0) + _scan_data(segs)
    return out + b"\xff\xd9"


# --- arithmetic (jcarith.c) -------------------------------------------------

class _QMEncoder:
    """jcarith.c's ``arith_encode`` and ``finish_pass``, bin states in
    bytearrays (bit 7 the MPS, the low 7 bits an ARITAB index)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc = 0, 0x10000, 0, 0
        self.ct, self.buffer = 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _stuffed(self, b: int):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _release(self):
        """Output the buffered byte and the stacked 0xFF bytes, which no
        carry reaches any more."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._stuffed(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st, i: int, val: int):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._release()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._release()
        if self.c & 0x7FFF800:
            self._zeros()
            self._stuffed((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._stuffed((self.c >> 11) & 0xFF)
        return bytes(self.out)


class _ArithScan:
    """One arithmetic-coded scan (jcarith.c ``encode_mcu`` and the four
    progressive routines), statistics per conditioning table."""

    def __init__(self, coded, comps, tables, ss, se, ah, al, progressive,
                 dac):
        self.coded, self.comps, self.tables = coded, comps, tables
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive = progressive
        self.dc_l = {t: dac.get(t, (0, 1))[0] for t in range(16)}
        self.dc_u = {t: dac.get(t, (0, 1))[1] for t in range(16)}
        self.ac_k = {t: dac.get(16 + t, 5) for t in range(16)}

    def start(self):
        self.e = _QMEncoder()
        self.dc_stats = {t >> 4: bytearray(64) for t in self.tables.values()}
        self.ac_stats = {t & 15: bytearray(256) for t in self.tables.values()}
        self.fixed = bytearray([113])
        self.last_dc = {ci: 0 for ci in self.comps}
        self.dc_ctx = {ci: 0 for ci in self.comps}

    def magnitude(self, st, i, v, stats, k_bins=None):
        """Figures F.8 and F.9 from bin i of ``st`` for v = |value| - 1;
        ``k_bins`` is the AC bins' (stats, X2 index), None for DC."""
        e = self.e
        m = 0
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if k_bins is None:
                st, i = stats, 20
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
            elif v2 >> 1:
                v2 >>= 1
                e.encode(st, i, 1)
                m <<= 1
                st, i = k_bins
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
        e.encode(st, i, 0)
        i += 14
        while m >> 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)
        return m

    def dc(self, ci, value):
        tbl = self.tables[ci] >> 4
        st = self.dc_stats[tbl]
        i = self.dc_ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            self.e.encode(st, i, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        self.e.encode(st, i, 1)
        if v > 0:
            self.e.encode(st, i + 1, 0)
            i += 2
            self.dc_ctx[ci] = 4
        else:
            v = -v
            self.e.encode(st, i + 1, 1)
            i += 3
            self.dc_ctx[ci] = 8
        v -= 1
        m = 0
        if v:
            m = 1 << (v.bit_length() - 1)
        self.magnitude(st, i, v, st)
        if m < (1 << self.dc_l[tbl]) >> 1:
            self.dc_ctx[ci] = 0
        elif m > (1 << self.dc_u[tbl]) >> 1:
            self.dc_ctx[ci] += 8

    def ac(self, ci, zz, ss, se):
        """AC coefficients ss..se of one block, values already shifted."""
        tbl = self.tables[ci] & 15
        st = self.ac_stats[tbl]
        ke = se
        while ke > 0 and not zz[ke]:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            self.e.encode(st, i, 0)
            while not zz[k]:
                self.e.encode(st, i + 1, 0)
                i += 3
                k += 1
            self.e.encode(st, i + 1, 1)
            v = zz[k]
            self.e.encode(self.fixed, 0, 0 if v > 0 else 1)
            self.magnitude(st, i + 2, abs(v) - 1, st,
                           (st, 189 if k <= self.ac_k[tbl] else 217))
            k += 1
        if k <= se:
            self.e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, ci, zz_al, zz_ah, ss, se):
        tbl = self.tables[ci] & 15
        st = self.ac_stats[tbl]
        ke = se
        while ke > 0 and not zz_al[ke]:
            ke -= 1
        kex = ke
        while kex > 0 and not zz_ah[kex]:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                self.e.encode(st, i, 0)
            while True:
                v = zz_al[k]
                if v:
                    if abs(v) >> 1:
                        self.e.encode(st, i + 2, abs(v) & 1)
                    else:
                        self.e.encode(st, i + 1, 1)
                        self.e.encode(self.fixed, 0, 0 if v > 0 else 1)
                    break
                self.e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            self.e.encode(st, 3 * (k - 1), 1)

    def block(self, ci, zz):
        if not self.progressive:
            self.dc(ci, zz[0])
            self.ac(ci, zz, 1, 63)
            return
        shift = lambda v, s: v >> s if v >= 0 else -((-v) >> s)  # noqa: E731
        if self.ss == 0 and self.ah == 0:
            self.dc(ci, zz[0] >> self.al)
        elif self.ss == 0:
            self.e.encode(self.fixed, 0, (zz[0] >> self.al) & 1)
        elif self.ah == 0:
            self.ac(ci, [shift(v, self.al) for v in zz], self.ss, self.se)
        else:
            self.ac_refine(ci, [shift(v, self.al) for v in zz],
                           [shift(v, self.ah) for v in zz], self.ss, self.se)

    def run(self, restart) -> bytes:
        segs = []
        for iv in _intervals(_mcus(self.coded, self.comps), restart):
            self.start()
            for mcu in iv:
                for ci, by, bx in mcu:
                    self.block(ci, self.coded.zigzag(ci)[by][bx])
            segs.append(self.e.finish())
        return _scan_data(segs)


def progression(n: int):
    """libjpeg's ``jpeg_simple_progression`` scan script for n components
    (3: the YCbCr one): (components, Ss, Se, Ah, Al) per scan."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    each = range(n)
    return ([(tuple(each), 0, 0, 0, 1)]
            + [((c,), 1, 5, 0, 2) for c in each]
            + [((c,), 6, 63, 0, 2) for c in each]
            + [((c,), 1, 63, 2, 1) for c in each]
            + [(tuple(each), 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in each])


def arithmetic_jpeg(coded: Coded, restart: int = 0, progressive=False,
                    scans=None, dac=None) -> bytes:
    """Arithmetic-coded JPEG: SOF9 (sequential: ``scans`` lists each
    scan's components, one interleaved scan by default) or SOF10
    (progressive: ``scans`` is a scan script as ``progression`` gives,
    by default that). ``dac`` {DAC index: value}: index t < 16 sets DC
    table t's (L, U), 16 + t AC table t's K (written in one DAC
    segment). Component i uses conditioning tables min(i, 1)."""
    dac = dac or {}
    out = _frame(coded, 0xCA if progressive else 0xC9)
    if dac:
        body = b""
        for idx, val in sorted(dac.items()):
            body += bytes([idx if idx < 16 else 0x10 | (idx - 16),
                           val[1] << 4 | val[0] if idx < 16 else val])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if progressive:
        script = scans or progression(len(coded.comps))
    else:
        script = [(tuple(c), 0, 63, 0, 0) for c in
                  (scans or [range(len(coded.comps))])]
    for comps, ss, se, ah, al in script:
        comps = list(comps)
        tables = {ci: 0x11 * min(ci, 1) for ci in comps}
        scan = _ArithScan(coded, comps, tables, ss, se, ah, al, progressive,
                          dac)
        out += _sos(coded, comps, tables, ss, se, ah, al) + scan.run(restart)
    return out + b"\xff\xd9"


# --- lossless (SOF3) -------------------------------------------------------

def _predict(x: np.ndarray, p: int) -> np.ndarray:
    """The predictions of T.81 H.1.2.1 for one component's samples
    (int64 [H, W]): predictor p inside, Ra along the first row, Rb down the
    first column, 0 at the origin (the caller adds 2^(P - Pt - 1))."""
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[p].copy()
    pred[0] = ra[0]
    pred[1:, 0] = rb[1:, 0]
    return pred


def downsample(planes, sampling) -> list:
    """Full-size uint8 planes -> each component at its sampling factors
    (the mean of each hmax/h x vmax/v cell, edges replicated, rounded)."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    out = []
    for plane, (h, v) in zip(planes, sampling):
        fx, fy = hmax // h, vmax // v
        H2, W2 = -(-height // fy) * fy, -(-width // fx) * fx
        p = np.pad(plane.astype(np.float64), ((0, H2 - height),
                                              (0, W2 - width)), "edge")
        out.append(np.rint(p.reshape(H2 // fy, fy, W2 // fx, fx).mean(
            (1, 3))).astype(np.uint8))
    return out


def lossless_jpeg(comps, predictor: int, pt: int = 0, restart_rows: int = 0,
                  sampling=None, size=None, ids=None, apps=b"") -> bytes:
    """Lossless Huffman JPEG (SOF3, one interleaved scan) of uint8
    component planes at their ``sampling`` factors (1x1 by default):
    samples shifted right by the point transform ``pt``, differences from
    ``predictor`` (1-7) modulo 2^16; the first row of the image and of each
    restart interval predicted from the left, its first sample from
    2^(7 - pt); ``restart_rows`` rows of MCUs per interval. ``size`` is
    the image's (height, width), the first plane's by default. The MCU
    padding is coded as zero differences."""
    n = len(comps)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = size or comps[0].shape
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    diffs = []
    for (h, v), plane in zip(sampling, comps):
        x = plane.astype(np.int64) >> pt
        d = np.zeros((mcuy * v, mcux * h), np.int64)
        rows = (restart_rows or mcuy) * v
        for y0 in range(0, x.shape[0], rows):
            part = x[y0:y0 + rows]
            pred = _predict(part, predictor)
            pred[0, 0] = 1 << (7 - pt)
            pred[0, 1:] = part[0, :-1]
            d[y0:y0 + part.shape[0], :x.shape[1]] = part - pred
        diffs.append(((d + 32768) & 0xFFFF) - 32768)
    body = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    body += bytes([n]) + b"".join(bytes([i, h << 4 | v, 0])
                                  for i, (h, v) in zip(ids, sampling))
    out = b"\xff\xd8" + apps + _segment(0xC3, body)
    restart = restart_rows * mcux
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    seq = [(ci, int(diffs[ci][my * v + y, mx * h + x]))
           for my in range(mcuy) for mx in range(mcux)
           for ci, (h, v) in enumerate(sampling)
           for y in range(v) for x in range(h)]
    tables = [min(ci, 1) for ci in range(n)]
    freq = {t: [0] * 256 for t in tables}
    for ci, v in seq:
        freq[tables[ci]][_category(v)[0]] += 1
    codes = {}
    for t in sorted(freq):
        counts, vals = optimal_table(freq[t])
        out += _dht(0, t, counts, vals)
        codes[t] = _codes(counts, vals)
    per = (restart or mcux * mcuy) * sum(h * v for h, v in sampling)
    segs = []
    for s0 in range(0, len(seq), per):
        w = _BitWriter()
        for ci, v in seq[s0:s0 + per]:
            s, bits = _category(v)
            w.put(*codes[tables[ci]][s])
            if 0 < s < 16:                  # category 16: 32768, no bits
                w.put(bits, s)
        segs.append(w.flush())
    sos = bytes([n]) + b"".join(bytes([i, tables[ci] << 4])
                                for ci, i in enumerate(ids))
    out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
    return out + _scan_data(segs) + b"\xff\xd9"


# --- the formats fixtures -------------------------------------------------

JFIF = _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))
TIMING_HW = (240, 320)
ENDOVIS_IDS = {"background": 0, "shaft": 300, "wrist": 4660,
               "clasper": 256, "needle": 65535}


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment: version 100, no flags, ``transform``."""
    return _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))


def ycc(rgb: np.ndarray) -> list:
    """JFIF's RGB -> YCbCr, rounded: three uint8 planes."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    planes = (0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128)
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in planes]


def cmyk(rgb: np.ndarray) -> list:
    """RGB -> CMYK with full black generation (k = 1 - max(r, g, b)), as
    Adobe files store it: every plane inverted (255 means no ink)."""
    x = rgb.astype(np.float64) / 255
    k = 1 - x.max(-1)
    ink = [(1 - x[..., i] - k) / np.maximum(1 - k, 1e-9) for i in range(3)]
    return [np.clip(np.rint(255 * (1 - p)), 0, 255).astype(np.uint8)
            for p in (*ink, k)]


def _tables(quality: int) -> dict:
    return {0: scaled_table(LUMA_Q, quality),
            1: scaled_table(CHROMA_Q, quality)}


def png16(img: np.ndarray, ctype: int, interlace: int = 0) -> bytes:
    """A 16-bit PNG of uint16 [H, W] or [H, W, C] in colour type ``ctype``
    (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA), plain or Adam7, each row's
    filter type its index mod 5 (every filter over 6-, 4-, 8- and 2-byte
    pixels)."""
    import struct
    import zlib

    from sam2_video_tpu_torch.data import image_io

    img = np.asarray(img, np.uint16)
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape

    def rows(part):
        h, w = part.shape[:2]
        b = part.astype(">u2").reshape(h, w * ch).view(np.uint8)
        return image_io._filter_rows(b, np.arange(h) % 5, 2 * ch).tobytes()

    passes = ([img] if not interlace else
              [img[y0::dy, x0::dx] for x0, y0, dx, dy in image_io.ADAM7])
    body = b"".join(rows(p) for p in passes if p.size)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(body, 9)) + chunk(b"IEND", b""))


def format_coverage() -> dict:
    """name -> (file bytes, its independent check): ("twin", a Huffman
    file of the same quantised coefficients, which Pillow must decode to
    the same RGB), ("samples", what ``np.asarray(Image.open(f))`` must
    give: a lossless file's source samples, shifted by its point
    transform and replicated up to full size; Pillow inverts CMYK) or
    None (Pillow's own CMYK files; 16-bit PNGs, checked against
    ``png16``'s samples by the test)."""
    out = {}
    img = _scene(37, 53, 21)

    def twin(name, coded, **kw):
        out[name] = (arithmetic_jpeg(coded, **kw), ("twin",
                                                     huffman_jpeg(coded)))

    q75 = _tables(75)
    for samp, name in (((2, 2), "s420"), ((2, 1), "s422"),
                       ((1, 2), "s440"), ((1, 1), "s444")):
        coded = quantise(ycc(img), [samp, (1, 1), (1, 1)], q75, [0, 1, 1],
                         apps=JFIF)
        twin(f"arith_{name}.jpg", coded,
             **{"s420": {}, "s422": {"restart": 3},
                "s440": {"scans": [[0], [2], [1]]},
                "s444": {"dac": {0: (2, 5), 1: (0, 0), 16: 2, 17: 30}}}[name])
        twin(f"arith_progressive_{name}.jpg", coded, progressive=True,
             restart=4 if name == "s444" else 0,
             dac={16: 9} if name == "s422" else None)
    grey = quantise([img[..., 1]], [(1, 1)], q75, [0])
    twin("arith_grey.jpg", grey, restart=5)
    twin("arith_progressive_grey.jpg", grey, progressive=True)
    g = np.random.default_rng(22)
    sat = (g.integers(0, 2, (5, 7, 3)) * 255).astype(np.uint8)
    sat = sat.repeat(8, 0).repeat(8, 1)
    sat[::3, ::5] = 255 - sat[::3, ::5]
    twin("arith_q100_saturated.jpg",
         quantise(ycc(sat), [(1, 1)] * 3, _tables(100), [0, 1, 1],
                  apps=JFIF))
    for h, w in ((1, 1), (7, 9), (17, 200)):
        twin(f"arith_size_{h}x{w}.jpg",
             quantise(ycc(_scene(h, w, h * w)), [(2, 2), (1, 1), (1, 1)],
                      q75, [0, 1, 1], apps=JFIF), restart=2)
    ink = cmyk(img)
    for name, planes, apps, samp in (
            ("cmyk", ink, adobe(0), [(1, 1)] * 4),
            ("cmyk_s420", ink, adobe(0), [(2, 2), (1, 1), (1, 1), (2, 2)]),
            ("cmyk_no_adobe", ink, b"", [(1, 1)] * 4),
            ("ycck", ycc(np.stack(ink[:3], -1)) + [ink[3]], adobe(2),
             [(1, 1)] * 4),
            ("ycck_s420", ycc(np.stack(ink[:3], -1)) + [ink[3]], adobe(2),
             [(2, 2), (1, 1), (1, 1), (2, 2)]),
            ("ycck_adobe1", ycc(np.stack(ink[:3], -1)) + [ink[3]],
             adobe(1), [(1, 1)] * 4)):
        coded = quantise(planes, samp, q75, [0, 1, 1, 0], apps=apps)
        out[f"{name}.jpg"] = (huffman_jpeg(coded), None)
        twin(f"arith_{name}.jpg", coded, restart=7)
        if name in ("cmyk", "ycck_s420"):
            twin(f"arith_progressive_{name}.jpg", coded, progressive=True)
    out["cmyk_pillow.jpg"] = (_pillow_cmyk(img), None)
    out["cmyk_pillow_progressive.jpg"] = (_pillow_cmyk(img,
                                                       progressive=True),
                                          None)
    src = _scene(23, 31, 23)

    def lossless(name, comps, expect, **kw):
        out[name] = (lossless_jpeg(comps, **kw), ("samples", expect))

    for p in range(1, 8):
        pt = p % 3
        lossless(f"lossless_grey_p{p}.jpg", [src[..., 1]],
                 src[..., 1] >> pt << pt, predictor=p, pt=pt,
                 restart_rows=4 if p in (2, 5) else 0)
    rgb = [src[..., i] for i in range(3)]
    lossless("lossless_rgb_p4_rst.jpg", rgb, src, predictor=4,
             restart_rows=3)
    lossless("lossless_rgb_adobe0_p6_pt1.jpg", rgb, src >> 1 << 1,
             predictor=6, pt=1, apps=adobe(0))
    lossless("lossless_rgb_ids_p7.jpg", rgb, src, predictor=7,
             ids=[82, 71, 66])
    ink = cmyk(src)
    lossless("lossless_cmyk_p5.jpg", ink, 255 - np.stack(ink, -1),
             predictor=5, apps=adobe(0))
    samp = [(2, 2), (1, 1), (1, 1)]
    comps = downsample(rgb, samp)
    full = [np.repeat(np.repeat(c, 2 // v, 0), 2 // h, 1)[:23, :31]
            for c, (h, v) in zip(comps, samp)]
    lossless("lossless_s420_p1_rst.jpg", comps, np.stack(full, -1),
             predictor=1, restart_rows=2, sampling=samp, size=(23, 31))
    vals = np.array([0, 1, 255, 256, 300, 0x1234, 0x8000, 0xFF00, 0xFFFF],
                    np.uint16)
    for ctype, ch, name in ((0, 1, "grey"), (2, 3, "rgb"),
                            (4, 2, "grey_alpha"), (6, 4, "rgba")):
        px = g.choice(vals, (13, 19, ch))
        px[..., 0] = np.arange(13 * 19).reshape(13, 19) * 263 % 65536
        for interlace in (0, 1):
            out[f"png16_{name}{'_adam7' if interlace else ''}.png"] = (
                png16(px[..., 0] if ch == 1 else px, ctype, interlace),
                ("png16", px))
    return out


def _pillow_cmyk(rgb: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def _video_frames() -> dict:
    """The JPEG video dataset's frames (``video_dataset``, decoded by
    Pillow): {file name: RGB}, with its annotations."""
    from PIL import Image

    ann = json.loads((ROOT / "video" / "annotations.json").read_text())
    return {im["file_name"]: np.asarray(Image.open(
        ROOT / "video" / "images" / im["file_name"]).convert("RGB"))
        for im in ann["images"]}, ann


def format_video(root: Path) -> dict:
    """The JPEG video dataset (2 videos x 8 frames of 240x320, the same
    annotations) with each frame written as a CMYK arithmetic-coded JPEG
    (SOF9, Adobe transform 0, quality 75, 1x1 sampling) -> {file name:
    its Huffman twin}."""
    frames, ann = _video_frames()
    (root / "images").mkdir(parents=True, exist_ok=True)
    twins = {}
    for name, rgb in frames.items():
        coded = quantise(cmyk(rgb), [(1, 1)] * 4, _tables(75), [0, 1, 1, 0],
                         apps=adobe(0))
        (root / "images" / name).write_bytes(arithmetic_jpeg(coded))
        twins[name] = huffman_jpeg(coded)
    (root / "annotations.json").write_text(json.dumps(ann))
    return twins


def timing_frames() -> dict:
    """240x320 frames of each new kind, for decode times: two video
    frames arithmetic-coded (YCbCr 4:2:0, quality 90), as CMYK Huffman
    (quality 90) and as lossless RGB (predictor 1). name -> (bytes,
    check) as ``format_coverage``."""
    frames, _ = _video_frames()
    out = {}
    for i, name in enumerate(sorted(frames)[::8]):
        rgb = frames[name]
        coded = quantise(ycc(rgb), [(2, 2), (1, 1), (1, 1)], _tables(90),
                         [0, 1, 1], apps=JFIF)
        out[f"arith_{i}.jpg"] = (arithmetic_jpeg(coded),
                                 ("twin", huffman_jpeg(coded)))
        coded = quantise(cmyk(rgb), [(1, 1)] * 4, _tables(90), [0, 1, 1, 0],
                         apps=adobe(0))
        out[f"cmyk_{i}.jpg"] = (huffman_jpeg(coded), None)
        out[f"lossless_{i}.jpg"] = (lossless_jpeg(
            [rgb[..., c] for c in range(3)], 1), ("samples", rgb))
    return out


def endovis16_tree(root: Path) -> None:
    """An EndoVis-layout tree (``labels.json``, ``images/*.png``,
    ``annotations/*.png``): two sequences of 3 frames at 48x64, 8-bit RGB
    frames, class-id masks as 16-bit grey PNGs whose ids (ENDOVIS_IDS)
    pass 255; one frame has no mask file, one mask holds only background."""
    from sam2_video_tpu_torch.data import image_io

    g = np.random.default_rng(24)
    labels = [{"name": k, "classid": v} for k, v in ENDOVIS_IDS.items()]
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(exist_ok=True)
    (root / "labels.json").write_text(json.dumps(labels))
    yy, xx = np.mgrid[0:48, 0:64]
    for seq in (3, 12):
        for f in range(3):
            name = f"seq_{seq}_frame{f:03d}.png"
            image_io.write_png(root / "images" / name, _scene(48, 64,
                                                              seq * 10 + f))
            if (seq, f) == (12, 2):
                continue
            ids = np.zeros((48, 64), np.uint16)
            if (seq, f) != (12, 1):
                ids[g.integers(20, 40):, :g.integers(10, 50)] = 300
                ids[5:15, 20 + 3 * f:44] = 4660
                ids[((yy - 30) ** 2 + (xx - 50) ** 2) < 40] = 65535
                ids[0, :f + 1] = 256
                ids[47, 63] = 7                    # an id with no label
            (root / "annotations" / name).write_bytes(png16(ids, 0, f % 2))


def _digest_of(data: bytes, path: Path) -> dict:
    """Pillow's ``convert("RGB")``, OpenCV's ``imread`` (None when it
    reads nothing) and, for a PNG, ``np.asarray(Image.open())``."""
    import cv2
    from PIL import Image

    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    cv = cv2.imread(str(path), cv2.IMREAD_COLOR
                    | cv2.IMREAD_IGNORE_ORIENTATION)
    d = {"shape": list(rgb.shape), "sha256": digest(rgb),
         "opencv_sha256": None if cv is None else digest(cv[..., ::-1])}
    if path.suffix == ".png":
        raw = np.asarray(Image.open(io.BytesIO(data)))
        d.update(raw_shape=list(raw.shape), raw_dtype=str(raw.dtype),
                 raw_sha256=digest_raw(raw))
    return d


def digest_raw(a: np.ndarray) -> str:
    """sha256 of an array's bytes in little-endian order."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()
                          ).hexdigest()


def endovis16_json_digest(root: Path) -> str:
    """sha256 of the JAX converter's JSON for ``root``, named by its path
    from the repository root (the JSON holds each frame's path), the
    converter run from the repository root as ``python
    data_tools/convert_endovis_to_coco.py <that path> <out.json>``."""
    import os

    sys.path.insert(0, str(REPO / "data_tools"))
    import convert_endovis_to_coco as tool

    with tempfile.TemporaryDirectory() as tmp:
        here = os.getcwd()
        os.chdir(REPO)
        try:
            tool.convert(str(root.relative_to(REPO)), f"{tmp}/out.json", 2)
        finally:
            os.chdir(here)
        return hashlib.sha256(Path(f"{tmp}/out.json").read_bytes()
                              ).hexdigest()


def generate_formats(root: Path = FORMATS) -> dict:
    """Writes the formats fixtures under ``root`` and their digests ->
    {relative path: check} for every file with an independent check (see
    ``format_coverage``)."""
    root = Path(root)
    checks = {}
    (root / "coverage").mkdir(parents=True, exist_ok=True)
    (root / "timing").mkdir(exist_ok=True)
    for sub, files in (("coverage", format_coverage()),
                       ("timing", timing_frames())):
        for name, (data, check) in files.items():
            (root / sub / name).write_bytes(data)
            checks[f"{sub}/{name}"] = check
    for name, twin in format_video(root / "video").items():
        checks[f"video/images/{name}"] = ("twin", twin)
    endovis16_tree(root / "endovis16")
    digests = {}
    for p in sorted(root.rglob("*")):
        if p.suffix in (".jpg", ".png") and "endovis16" not in p.parts:
            digests[p.relative_to(root).as_posix()] = _digest_of(
                p.read_bytes(), p)
    (root / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    if root.resolve() == FORMATS.resolve():
        (root / "endovis16.json.sha256").write_text(
            endovis16_json_digest(root / "endovis16") + "\n")
    return checks


def digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()
                          ).hexdigest()


def generate(root: Path = ROOT) -> None:
    from PIL import Image

    root = Path(root)
    (root / "coverage").mkdir(parents=True, exist_ok=True)
    for name, data in coverage_files().items():
        (root / "coverage" / name).write_bytes(data)
    video_dataset(root / "video")
    digests = {}
    for p in sorted(root.rglob("*.jpg")):
        rgb = np.asarray(Image.open(p).convert("RGB"))
        digests[p.relative_to(root).as_posix()] = {
            "shape": list(rgb.shape), "sha256": digest(rgb)}
    (root / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    generate(Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT)
    generate_formats(Path(sys.argv[2]) if len(sys.argv) > 2 else FORMATS)
