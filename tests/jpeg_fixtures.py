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
