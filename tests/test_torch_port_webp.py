"""The port's WebP reader (``data/webp.py``: the container, VP8, VP8L and
the alpha plane; the C++ helper ``csrc/webp_decode.cpp`` and the numpy
references beside it) held to Pillow, OpenCV and libwebp bit for bit on
the CPU, and the frames it reads held to the JAX package's readers:

- the committed WebP fixtures (``tests/webp_fixtures.py``) regenerated
  byte for byte, each read to its digests of Pillow's ``convert("RGB")``
  (the JAX loader), the JAX eval's reader (OpenCV's ``imread``) and
  ``np.asarray(Image.open(f))``, with the helper and with the numpy
  references, and to the libraries themselves;
- the stages one by one on the coverage files: VP8's Y, U and V planes
  against libwebp's ``WebPDecodeYUV``, VP8L's ARGB and the alpha plane
  against Pillow's, the helper's loops against the references;
- a hypothesis sweep of lossy and lossless files against Pillow;
- truncated and corrupt files raise ``ValueError`` naming the file;
- the JAX ``COCOIndex`` / ``ClipLoader`` (Pillow) and the port's over the
  WebP video; the JAX ``InferenceRunner._load_frames`` (OpenCV) and the
  port's over every fixture.
"""

import io
import json
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import raster_fixtures as rf
import webp_fixtures as wf
from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io, webp
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.eval.inference import InferenceRunner as TRunner

cv2 = pytest.importorskip("cv2")
ROOT = wf.WEBP
DIGESTS = json.loads((ROOT / "digests.json").read_text())
COVERAGE = sorted((ROOT / "coverage").iterdir())
VIDEO = ROOT / "video"
FLAGS = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION


def _libraries(path):
    """Pillow's RGB and raw arrays and size, and the JAX eval's frame
    (OpenCV's, else Pillow's), of the file at ``path``."""
    with Image.open(path) as im:
        size, raw = im.size, np.asarray(im)
        rgb = np.asarray(im.convert("RGB"))
    cv = cv2.imread(str(path), FLAGS)
    return rgb, raw, size, rgb if cv is None else cv[..., ::-1]


@pytest.fixture(params=["native", "numpy"])
def helpers(request, monkeypatch):
    """The C++ helper, which must build, or the numpy references."""
    if request.param == "native":
        assert image_io.host_build.load("webp_decode"), \
            "the C++ WebP helper did not build"
    else:
        monkeypatch.setattr(image_io, "_helpers", {"webp_decode": None})
    return request.param


def _kind(path) -> str:
    f = webp.WebPFile(path.read_bytes(), path.name)
    return "vp8" if f.frame.vp8 is not None else "vp8l"


def test_regenerated_byte_for_byte(tmp_path):
    """``webp_fixtures.generate`` writes the committed bytes again, and the
    folder stays small."""
    wf.generate(tmp_path)
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in ROOT.rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path).as_posix()
                 for p in tmp_path.rglob("*") if p.is_file())
    assert got == want
    for rel in got:
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    assert sum((ROOT / r).stat().st_size for r in want) < 1024 * 1024
    assert max(p.stat().st_size for p in COVERAGE) < 16 * 1024


def test_fixtures_read_to_their_digests(helpers):
    """Every fixture through ``read_rgb`` (both readers), ``read_raw`` and
    ``image_size``: equal to its digests and, with the helper, the
    coverage and timing files to Pillow and OpenCV themselves (the numpy
    references read the coverage files)."""
    assert len(DIGESTS) == 77
    for rel, want in DIGESTS.items():
        if helpers == "numpy" and not rel.startswith("coverage/"):
            continue
        p = ROOT / rel
        rgb, cv = image_io.read_rgb(p), image_io.read_rgb(p, reader="opencv")
        raw = image_io.read_raw(p)
        assert list(image_io.image_size(p)) == want["size"], rel
        assert list(rgb.shape) == want["size"][::-1] + [3], rel
        assert rf.digest(rgb) == want["sha256"], rel
        assert rf.digest(cv) == want["opencv_sha256"], rel
        assert [list(raw.shape), raw.dtype.str] == [want["raw_shape"],
                                                    want["raw_dtype"]], rel
        assert rf.digest_raw(raw) == want["raw_sha256"], rel
        if helpers == "numpy" or rel.startswith("video/"):
            continue
        lib_rgb, lib_raw, size, lib_cv = _libraries(p)
        np.testing.assert_array_equal(rgb, lib_rgb, err_msg=rel)
        np.testing.assert_array_equal(raw, lib_raw, err_msg=rel)
        np.testing.assert_array_equal(cv, lib_cv, err_msg=rel)
        assert image_io.image_size(p) == size, rel


def test_readers_agree_on_every_fixture():
    """Pillow's ``convert("RGB")`` and OpenCV's ``imread`` give the same
    bits on every kind of WebP tried, and ``imread`` reads each one."""
    for rel, want in DIGESTS.items():
        assert want["sha256"] == want["opencv_sha256"], rel
        assert not want["opencv_none"], rel


# the Pillow mode of the files whose flags disagree with their chunks
MODES = {"lossless_alpha_bit_set.webp": "RGBA",
         "vp8x_alpha_flag_vp8l_opaque.webp": "RGB",
         "vp8x_alph_without_flag.webp": "RGBA",
         "vp8x_alpha_flag_without_alph.webp": "RGBA",
         "anim_offset.webp": "RGB", "anim_lossless_alpha.webp": "RGBA",
         "lossless_palette4.webp": "RGB", "alpha_raw_filter0.webp": "RGBA"}


@pytest.mark.parametrize("name", sorted(MODES))
def test_pillow_mode_is_what_libwebp_reports(name):
    """``read_raw`` has 4 channels exactly where Pillow opens the file as
    "RGBA" (libwebp's ``WebPGetFeatures``), and an alpha plane that the
    demuxer drops (no ``VP8X`` alpha flag) reads as 255."""
    p = ROOT / "coverage" / name
    with Image.open(p) as im:
        assert im.mode == MODES[name]
    raw = image_io.read_raw(p)
    assert raw.shape[-1] == len(MODES[name])
    if name in ("vp8x_alph_without_flag.webp",
                "vp8x_alpha_flag_without_alph.webp"):
        assert (raw[..., 3] == 255).all()


def test_animation_first_frame_on_a_zeroed_canvas():
    """The animated file's first frame (61x45 at (4, 6) on an 80x60
    canvas whose ANIM background is red) is composed onto zeros, as
    ``WebPAnimDecoder`` composes a key frame; the EXIF orientation of a
    ``VP8X`` file is not applied."""
    rgb = image_io.read_rgb(ROOT / "coverage" / "anim_offset.webp")
    assert rgb.shape == (60, 80, 3)
    inside = np.zeros((60, 80), bool)
    inside[6:51, 4:65] = True
    assert not rgb[~inside].any() and rgb[inside].any()
    assert image_io.image_size(ROOT / "coverage"
                               / "exif_orientation6.webp") == (17, 33)


@pytest.mark.parametrize("path", [p for p in COVERAGE if _kind(p) == "vp8"],
                         ids=lambda p: p.name)
def test_vp8_planes_match_libwebp(path, helpers):
    """VP8 to Y, U and V, the helper's and the reference's, equal to
    libwebp's ``WebPDecodeYUV`` (a still image) or to each other (the
    first frame of an animation); then the upsampler and colour
    conversion equal Pillow's RGB inside the frame."""
    data = path.read_bytes()
    f = webp.WebPFile(data, path.name)
    y, u, v = webp.vp8_decode(f.frame.vp8, path.name)
    if f.animated:
        want = webp.vp8_decode_numpy(f.frame.vp8, path.name)
    else:
        want = wf.decode_yuv(data)
    for got, ref in zip((y, u, v), want):
        np.testing.assert_array_equal(got, ref)
    fr = f.frame
    np.testing.assert_array_equal(
        webp.yuv_to_rgb(y, u, v),
        _libraries(path)[0][fr.y:fr.y + fr.height, fr.x:fr.x + fr.width])


@pytest.mark.parametrize("path", [p for p in COVERAGE if _kind(p) == "vp8l"],
                         ids=lambda p: p.name)
def test_vp8l_argb_matches_pillow(path, helpers):
    """VP8L to ARGB equal to Pillow's RGBA of the frame (alpha too)."""
    f = webp.WebPFile(path.read_bytes(), path.name)
    argb = webp.vp8l_decode(f.frame.vp8l, name=path.name)
    with Image.open(path) as im:
        rgba = np.asarray(im.convert("RGBA"))
    fr = f.frame
    rgba = rgba[fr.y:fr.y + fr.height, fr.x:fr.x + fr.width]
    for c, s in enumerate((16, 8, 0)):
        np.testing.assert_array_equal((argb >> s) & 255, rgba[..., c])
    if f.has_alpha:
        np.testing.assert_array_equal(argb >> 24, rgba[..., 3])


@pytest.mark.parametrize("path", [p for p in COVERAGE
                                  if p.name.startswith("alpha_")],
                         ids=lambda p: p.name)
def test_alpha_plane_matches_pillow(path, helpers):
    """The ``ALPH`` chunk (raw or VP8L, each filter) to the alpha plane
    Pillow gives."""
    f = webp.WebPFile(path.read_bytes(), path.name)
    a = webp.decode_alpha(f.frame.alph, f.frame.width, f.frame.height,
                          path.name)
    with Image.open(path) as im:
        np.testing.assert_array_equal(a, np.asarray(im)[..., 3])


def test_helper_loops_equal_their_references():
    """The alpha unfilter and the upsampler / colour conversion through
    the C++ helper equal the numpy references on random planes of odd and
    even sizes."""
    assert image_io.host_build.load("webp_decode")
    g = np.random.default_rng(3)
    for h, w in ((1, 1), (1, 7), (6, 1), (5, 8), (8, 5), (9, 11)):
        plane = g.integers(0, 256, (h, w), dtype=np.uint8)
        for method in range(4):
            np.testing.assert_array_equal(
                webp.alpha_unfilter(plane, method),
                webp.alpha_unfilter_numpy(plane, method))
            np.testing.assert_array_equal(
                webp.alpha_unfilter_numpy(wf.alpha_filter(plane, method),
                                          method), plane)
        uv = [g.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                         dtype=np.uint8) for _ in range(2)]
        np.testing.assert_array_equal(webp.yuv_to_rgb(plane, *uv),
                                      webp.yuv_to_rgb_numpy(plane, *uv))


@settings(max_examples=12, deadline=None, database=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64), lossless=st.booleans(),
       quality=st.integers(0, 100), method=st.integers(0, 6),
       alpha=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_sweep_matches_pillow(h, w, lossless, quality, method, alpha, seed,
                              tmp_path_factory):
    """Random sizes, codecs, qualities, methods and alpha: the port (C++
    helper) equal to Pillow and to the JAX eval's reader."""
    img = rf.scene(h, w, seed)
    if alpha:
        img = np.dstack([img, wf._alpha_plane(h, w, seed)])
    p = tmp_path_factory.mktemp("sweep") / "s.webp"
    p.write_bytes(wf.encode(img, lossless=int(lossless), quality=quality,
                            method=method))
    rgb, raw, size, cv = _libraries(p)
    np.testing.assert_array_equal(image_io.read_rgb(p), rgb)
    np.testing.assert_array_equal(image_io.read_raw(p), raw)
    np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"), cv)
    assert image_io.image_size(p) == size


def _broken():
    """(name, bytes, what the message says) of truncated and corrupt
    files; Pillow refuses each one."""
    lossy = (ROOT / "coverage" / "lossy_q50.webp").read_bytes()
    lossless = (ROOT / "coverage" / "lossless_m4_q75.webp").read_bytes()
    alpha = (ROOT / "coverage" / "alpha_vp8l_filter1.webp").read_bytes()
    anim = (ROOT / "coverage" / "anim_offset.webp").read_bytes()

    def riff_fixed(data):                 # the RIFF size made to fit
        return data[:4] + (len(data) - 8).to_bytes(4, "little") + data[8:]

    short_vp8 = riff_fixed(lossy[:-30])
    short_vp8 = (short_vp8[:16] + (len(short_vp8) - 20).to_bytes(
        4, "little") + short_vp8[20:])    # the chunk made to fit too
    bad_code = bytearray(lossless)
    bad_code[25:29] = b"\xff\xff\xff\xff"
    bad_alph = bytearray(alpha)
    bad_alph[alpha.index(b"ALPH") + 8] |= 0xC0
    return [("truncated_lossy.webp", lossy[:-30], "truncated WebP"),
            ("truncated_lossless.webp", lossless[:-30], "truncated WebP"),
            ("truncated_anim.webp", anim[:-30], "truncated WebP"),
            ("chunk_past_end.webp", riff_fixed(lossy[:-30]),
             "truncated WebP"),
            ("short_vp8_frame.webp", short_vp8, "WebP"),
            ("bad_start_code.webp", lossy[:23] + b"\0" + lossy[24:],
             "VP8 frame header"),
            ("bad_vp8l_signature.webp", lossless[:20] + b"\0"
             + lossless[21:], "VP8L header"),
            ("bad_vp8l_codes.webp", bytes(bad_code), "WebP"),
            ("bad_alph_header.webp", bytes(bad_alph), "ALPH header"),
            ("no_image.webp", wf.riff(wf.vp8x(0, 4, 4)), "without an image"),
            ("frame_off_canvas.webp", wf.riff(
                wf.vp8x(0x02, 40, 40), wf.chunk(b"ANIM", bytes(6)),
                wf.anmf(30, 30, (ROOT / "coverage"
                                 / "lossy_17x33.webp").read_bytes())),
             "outside its 40x40 canvas")]


@pytest.mark.parametrize("name,data,what", _broken(),
                         ids=[b[0] for b in _broken()])
def test_broken_file_raises_naming_the_file(name, data, what, tmp_path,
                                            helpers):
    """A truncated or corrupt WebP raises ValueError naming the file and
    WebP, with the helper and with the references, where Pillow raises
    too."""
    p = tmp_path / name
    p.write_bytes(data)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        with Image.open(p) as im:
            im.load()
    for reader in ("pillow", "opencv"):
        with pytest.raises(ValueError, match=name) as e:
            image_io.read_rgb(p, reader=reader)
        assert what in str(e.value) and "WebP" in str(e.value)


def test_clip_loader_on_webp_video_matches_jax():
    """The WebP video through both packages' index, dataset and loader
    (JAX: Pillow; port: its reader), frames at 64 px and every field of
    every batch equal."""
    images = str(VIDEO / "images")
    cfg = dict(clip_length=4, stride=4, prompt_type="point", max_objects=4,
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
    kw = dict(batch_size=2, seed=5)
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
    """``InferenceRunner._load_frames`` of both packages (JAX: OpenCV's
    ``imread``, Pillow where it returns None) on every coverage and timing
    fixture as a one-frame clip and on an 8-frame clip of the WebP
    video."""
    assert sys.modules[JRunner.__module__]._cv2 is not None
    runner = types.SimpleNamespace(image_root=None)
    files = COVERAGE + sorted((ROOT / "timing").iterdir())
    assert len(files) == 62
    for p in files:
        clip = [{"file_name": p.name, "path": str(p)}]
        want = JRunner._load_frames(runner, clip)
        got = TRunner._load_frames(runner, clip)
        assert got.dtype == want.dtype == np.uint8, p.name
        np.testing.assert_array_equal(got, want, err_msg=p.name)
    frames = json.loads((VIDEO / "annotations.json").read_text())["images"]
    runner = types.SimpleNamespace(image_root=str(VIDEO / "images"))
    want = JRunner._load_frames(runner, frames[8:16])
    got = TRunner._load_frames(runner, frames[8:16])
    assert got.shape == (8, 240, 320, 3)
    np.testing.assert_array_equal(got, want)


def test_in_memory_and_path_reads_agree():
    """``webp.decode_webp`` / ``webp_raw`` / ``webp_size`` on bytes equal
    ``read_rgb`` / ``read_raw`` / ``image_size`` on the file."""
    for name in ("alpha_vp8l_filter3.webp", "anim_lossless_alpha.webp",
                 "lossy_17x33.webp"):
        p = ROOT / "coverage" / name
        data = p.read_bytes()
        for reader in ("pillow", "opencv"):
            np.testing.assert_array_equal(webp.decode_webp(data, name, reader),
                                          image_io.read_rgb(p, reader=reader))
        np.testing.assert_array_equal(webp.webp_raw(data, name),
                                      image_io.read_raw(p))
        assert webp.webp_size(data, name) == image_io.image_size(p)
        with Image.open(io.BytesIO(data)) as im:
            assert webp.webp_size(data, name) == im.size
