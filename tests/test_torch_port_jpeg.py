"""The port's JPEG decoder (``data/image_io.py`` ``decode_jpeg``: the C++
helper ``csrc/jpeg_decode.cpp`` and the numpy reference
``decode_jpeg_numpy``) held to Pillow's ``Image.open(p).convert("RGB")``
bit for bit on the CPU, and the JPEG frames it reads held to the JAX
package's readers:

- every committed fixture (``tests/jpeg_fixtures.py``: the five samplings,
  grey, restart intervals, optimised tables, progressive, quality 100 on
  saturated colours, odd sizes, EXIF orientation, RGB components, IDCT
  sums past the range-limit table, a 480x854 frame, the video dataset)
  decoded by both equal to Pillow and to ``digests.json``; the fixtures
  regenerated byte for byte;
- a hypothesis sweep of sizes 1-96, quality 5-100, the five samplings,
  restart intervals, progressive and optimised files against Pillow;
- the kinds it refuses, which Pillow refuses too, raise ``ValueError``
  naming the file (``tests/test_torch_port_formats.py`` holds the kinds
  added since: arithmetic-coded, lossless, CMYK / YCCK JPEG);
- the JAX ``COCOIndex`` / ``ClipDataset`` / ``ClipLoader`` (Pillow) and the
  port's over the JPEG video dataset: the same frames and batches, prompts
  included; JAX's ``InferenceRunner._load_frames`` (OpenCV) and the port's:
  the same arrays.
"""

import io
import json
import sys
import types
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import jpeg_fixtures
from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.eval.inference import InferenceRunner as TRunner

cv2 = pytest.importorskip("cv2")
ROOT = jpeg_fixtures.ROOT
DIGESTS = json.loads((ROOT / "digests.json").read_text())
VIDEO = ROOT / "video"
SAMPLINGS = (444, 422, 420, 440, 411)


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.fixture(params=["native", "numpy"])
def decode(request):
    if request.param == "numpy":
        return image_io.decode_jpeg_numpy
    assert image_io.host_build.load("jpeg_decode"), \
        "the C++ JPEG decoder did not build"
    return image_io.decode_jpeg


def test_fixtures_decode_to_their_digests(decode):
    """Every committed JPEG: equal to Pillow and to its digest."""
    assert len(DIGESTS) == len(list(ROOT.rglob("*.jpg"))) >= 30
    for rel, want in DIGESTS.items():
        data = (ROOT / rel).read_bytes()
        got = decode(data, rel)
        assert list(got.shape) == want["shape"], rel
        assert jpeg_fixtures.digest(got) == want["sha256"], rel
        np.testing.assert_array_equal(got, _pillow(data), err_msg=rel)


def test_regenerated_fixtures_are_byte_equal(tmp_path):
    jpeg_fixtures.generate(tmp_path)
    got = sorted(p.relative_to(tmp_path).as_posix()
                 for p in tmp_path.rglob("*") if p.is_file())
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in ROOT.rglob("*") if p.is_file())
    assert got == want
    for rel in want:
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    assert sum((ROOT / rel).stat().st_size for rel in want) <= 512 * 1024


@settings(max_examples=40, deadline=None, database=None)
@given(h=st.integers(1, 96), w=st.integers(1, 96),
       quality=st.integers(5, 100), sampling=st.sampled_from(SAMPLINGS),
       restart=st.sampled_from([0, 0, 1, 3]), progressive=st.booleans(),
       optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_sweep_matches_pillow(h, w, quality, sampling, restart, progressive,
                              optimize, seed):
    """OpenCV's encoder (libjpeg-turbo) over noise on a gradient: both
    decoders equal to Pillow."""
    img = jpeg_fixtures._scene(h, w, seed)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    data = enc.tobytes()
    want = _pillow(data)
    np.testing.assert_array_equal(image_io.decode_jpeg(data), want)
    np.testing.assert_array_equal(image_io.decode_jpeg_numpy(data), want)


# the kinds of ``_refused`` that Pillow refuses as well, and OpenCV but for
# a truncated progressive file (both decode a corrupt stream with libjpeg's
# warnings)
PILLOW_REFUSES = ("sof11.jpg", "sof5.jpg", "lossless_ycbcr.jpg",
                  "lossless_ycck.jpg", "lossless_part_row.jpg", "two.jpg",
                  "twelve.jpg", "cut.jpg", "cut_progressive.jpg")


def _refused():
    """name -> (bytes, what the message says). Lossless YCbCr and YCCK,
    and a lossless restart interval that is not a whole number of MCU
    rows, are written by the formats fixtures' encoder."""
    img = jpeg_fixtures._scene(40, 48, 9)
    base = jpeg_fixtures._pillow(img)
    sof = base.index(b"\xff\xc0")

    def header(marker: bytes) -> bytes:          # the SOF0 marker replaced
        return base[:sof] + marker + base[sof + 2:]

    twelve = bytearray(base)
    twelve[sof + 4] = 12
    prog = jpeg_fixtures._pillow(img, progressive=True)
    junk = bytearray(base)           # 64 one bits: no Huffman code
    mid = (base.index(b"\xff\xda") + len(base)) // 2
    junk[mid:mid + 16] = b"\xff\x00" * 8
    unknown = base[:sof] + b"\xff\xc8\x00\x02" + base[sof:]
    sos = base.index(b"\xff\xda")
    rest = base[sos + 2 + int.from_bytes(base[sos + 2:sos + 4], "big"):]

    def scan(pairs: list) -> bytes:   # the SOS header listing ``pairs``
        body = bytes([len(pairs), *sum(pairs, ()), 0, 63, 0])
        return (base[:sos] + b"\xff\xda" + (len(body) + 2).to_bytes(2, "big")
                + body + rest)

    rgb = [img[..., i] for i in range(3)]
    grey = jpeg_fixtures.lossless_jpeg([img[..., 0]], 1, restart_rows=2)
    dri = grey.index(b"\xff\xdd") + 4
    part_row = grey[:dri] + (48 * 2 + 5).to_bytes(2, "big") + grey[dri + 2:]
    two = jpeg_fixtures.huffman_jpeg(jpeg_fixtures.quantise(
        rgb[:2], [(1, 1)] * 2, jpeg_fixtures._tables(75), [0, 1]))
    return {"sof11.jpg": (grey.replace(b"\xff\xc3", b"\xff\xcb", 1),
                          "arithmetic-coded lossless JPEG"),
            "sof5.jpg": (header(b"\xff\xc5"), "hierarchical JPEG"),
            "lossless_ycbcr.jpg": (jpeg_fixtures.lossless_jpeg(
                rgb, 1, apps=jpeg_fixtures.JFIF), "lossless JPEG in YCbCr"),
            "lossless_ycck.jpg": (jpeg_fixtures.lossless_jpeg(
                jpeg_fixtures.cmyk(img), 1, apps=jpeg_fixtures.adobe(2)),
                "lossless JPEG in YCCK"),
            "lossless_part_row.jpg": (part_row, "restart"),
            "two.jpg": (two, "2-component JPEG"),
            "twelve.jpg": (bytes(twelve), "12-bit JPEG"),
            "cut.jpg": (base[:len(base) // 2], "truncated"),
            "cut_progressive.jpg": (prog[:2 * len(prog) // 3], "truncated"),
            "ones.jpg": (bytes(junk), "bad Huffman code"),
            "jpg_marker.jpg": (unknown, "marker 0xC8"),
            "sos_ns5.jpg": (scan([(1, 0x00)] * 5), "lists 5 components"),
            "sos_ns0.jpg": (scan([]), "lists 0 components"),
            "sos_twice.jpg": (scan([(1, 0x00), (1, 0x11), (2, 0x11)]),
                              "lists a component twice")}


@pytest.mark.parametrize("helper", [True, False], ids=["native", "numpy"])
def test_refused_kinds_raise_naming_the_file(helper, tmp_path, monkeypatch):
    if not helper:
        monkeypatch.setattr(image_io, "_helpers", {"jpeg_decode": None})
    for name, (data, what) in _refused().items():
        (tmp_path / name).write_bytes(data)
        if name in PILLOW_REFUSES:
            with pytest.raises(OSError):
                Image.open(tmp_path / name).convert("RGB")
            # OpenCV decodes what a truncated progressive file holds
            read = cv2.imread(str(tmp_path / name), cv2.IMREAD_COLOR)
            assert (read is None) == (name != "cut_progressive.jpg"), name
        with pytest.raises(ValueError, match=what) as err:
            image_io.read_rgb(tmp_path / name)
        assert name in str(err.value), err.value


def test_without_the_helper_warns_once(monkeypatch):
    monkeypatch.setattr(image_io, "_helpers", {})
    monkeypatch.setattr(image_io.host_build, "load", lambda name: None)
    data = (ROOT / "coverage" / "s420.jpg").read_bytes()
    with pytest.warns(RuntimeWarning, match="numpy reference"):
        np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                      _pillow(data))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        image_io.decode_jpeg(data)


def test_read_rgb_dispatches_on_the_first_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as what they are."""
    jpeg = (ROOT / "coverage" / "grey.jpg").read_bytes()
    (tmp_path / "a.png").write_bytes(jpeg)
    rgb = _pillow(jpeg)
    image_io.write_png(tmp_path / "b.jpg", rgb)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / "b.jpg"), rgb)
    assert image_io.image_size(tmp_path / "a.png") == (83, 61)


@pytest.mark.parametrize("prompt", ["point", "box"])
def test_clip_loader_on_jpeg_matches_jax(prompt):
    """The JPEG video dataset through both packages' index, dataset and
    loader (JAX: Pillow; port: its decoder), frames at 64 px and every
    field of every batch, prompts included, equal."""
    images = str(VIDEO / "images")
    cfg = dict(clip_length=4, stride=4, prompt_type=prompt, max_objects=4,
               num_pos_points=2, num_neg_points=1, image_root=images)
    json_path = VIDEO / "annotations.json"
    jidx, tidx = jcoco.COCOIndex(json_path, 64), tcoco.COCOIndex(json_path,
                                                                 64)
    for i in range(len(jidx.images)):
        np.testing.assert_array_equal(
            tidx.load_image(i, images, normalize=False),
            jidx.load_image(i, images, normalize=False))
    jds = jpipe.ClipDataset(jidx, jpipe.ClipDatasetConfig(**cfg))
    tds = tpipe.ClipDataset(tidx, tpipe.ClipDatasetConfig(**cfg))
    assert len(tds) == len(jds) == 4
    kw = dict(batch_size=2, seed=3)
    n = 0
    for tb, jb in zip(tpipe.ClipLoader(tds, **kw), jpipe.ClipLoader(jds, **kw),
                      strict=True):
        for k in FIELDS:
            x, y = getattr(tb, k).numpy(), np.asarray(getattr(jb, k))
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        n += 1
    assert n == 2


def test_inference_frames_match_jax():
    """``InferenceRunner._load_frames`` of both packages on the JPEG video
    (JAX: OpenCV's ``imread``): the same uint8 arrays, one frame and a
    clip of eight."""
    frames = json.loads((VIDEO / "annotations.json").read_text())["images"]
    runner = types.SimpleNamespace(image_root=str(VIDEO / "images"))
    assert sys.modules[JRunner.__module__]._cv2 is not None
    for clip in (frames[:1], frames[8:16]):
        want = JRunner._load_frames(runner, clip)
        got = TRunner._load_frames(runner, clip)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == (len(clip), 240, 320, 3)
        np.testing.assert_array_equal(got, want)
