"""The port's TIFF, BMP and GIF readers (``data/image_io.py``: the C++
helper ``csrc/raster_decode.cpp`` and the numpy references beside it) held
to Pillow and OpenCV bit for bit on the CPU, and the frames they read held
to the JAX package's readers:

- the committed raster fixtures (``tests/raster_fixtures.py``) regenerated
  byte for byte, each read to its digests of Pillow's ``convert("RGB")``
  (the JAX loader), the JAX eval's reader (OpenCV's ``imread``, Pillow's
  where that returns None) and ``np.asarray(Image.open(f))``, with the
  helper and with the numpy references, and to the libraries themselves;
- every entry of Pillow's ``TiffImagePlugin.OPEN_INFO`` as an uncompressed
  and an LZW file, against both libraries;
- a hypothesis sweep of LZW, PackBits and deflate TIFF and RLE8 BMP
  against Pillow;
- the kinds the port refuses raise ``ValueError`` naming the file;
- the JAX ``COCOIndex`` / ``ClipLoader`` (Pillow) and the port's over the
  TIFF video; the JAX ``InferenceRunner._load_frames`` (OpenCV) and the
  port's over every fixture.
"""

import json
import sys
import types
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, TiffImagePlugin

import raster_fixtures as rf
from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.eval.inference import InferenceRunner as TRunner

cv2 = pytest.importorskip("cv2")
ROOT = rf.RASTER
DIGESTS = json.loads((ROOT / "digests.json").read_text())
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
    """The C++ helpers, which must build, or the numpy references."""
    if request.param == "native":
        assert image_io.host_build.load("raster_decode"), \
            "the C++ raster helper did not build"
    else:
        monkeypatch.setattr(image_io, "_helpers",
                            {"raster_decode": None, "jpeg_decode": None})
    return request.param


def test_regenerated_byte_for_byte(tmp_path):
    """``raster_fixtures.generate`` writes the committed bytes again."""
    rf.generate(tmp_path)
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in ROOT.rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path).as_posix()
                 for p in tmp_path.rglob("*") if p.is_file())
    assert got == want
    for rel in got:
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    assert all((ROOT / r).stat().st_size < 256 * 1024 for r in want)
    assert max((ROOT / r).stat().st_size for r in want
               if r.startswith("coverage/")) < 16 * 1024


def test_fixtures_read_to_their_digests(helpers):
    """Every fixture through ``read_rgb`` (both readers), ``read_raw`` and
    ``image_size``: equal to its digests (``ValueError`` from the loader's
    reader where Pillow cannot load the file) and, for the coverage and
    timing files, to Pillow and OpenCV themselves."""
    assert len(DIGESTS) == 98
    for rel, want in DIGESTS.items():
        p = ROOT / rel
        cv = image_io.read_rgb(p, reader="opencv")
        assert rf.digest(cv) == want["opencv_sha256"], rel
        assert list(image_io.image_size(p)) == want["size"], rel
        if want["sha256"] is None:
            with pytest.raises(ValueError, match=p.name):
                image_io.read_rgb(p)
            with pytest.raises(ValueError, match=p.name):
                image_io.read_raw(p)
            continue
        rgb, raw = image_io.read_rgb(p), image_io.read_raw(p)
        assert list(rgb.shape) == want["size"][::-1] + [3], rel
        assert rf.digest(rgb) == want["sha256"], rel
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


# the two readers' differences, each pinned by a fixture (True: the
# digests differ; "none": imread reads nothing, the eval takes Pillow's;
# "pillow fails": Pillow cannot load the file, OpenCV reads it)
READER_DIFFERENCES = {
    "tiff_grey16.tif": True, "tiff_grey16_be_lzw_pred2.tif": True,
    "tiff_rgb16.tif": True, "tiff_rgba_unassoc.tif": True,
    "tiff_rgba_assoc.tif": True, "tiff_cmyk.tif": True,
    "tiff_cmyk_pillow.tif": False, "tiff_float32.tif": "none",
    "tiff_float32_lzw_pred3.tif": "none",
    "tiff_int32_deflate_pred2.tif": "none",
    "tiff_orientation3.tif": False, "tiff_orientation6.tif": "none",
    "tiff_tiled_orientation2.tif": True, "tiff_multipage.tif": False,
    "tiff_ycbcr_none.tif": "pillow fails", "tiff_ycbcr_lzw.tif": False,
    "tiff_palette8.tif": False, "tiff_bilevel.tif": False,
    "bmp16_555.bmp": True, "bmp16_565_bitfields.bmp": True,
    "bmp16_565_bitfields_v5.bmp": "none", "bmp4_grey_ramp.bmp": True,
    "bmp_rle8_eol.bmp": False, "bmp_rle8_delta.bmp": True,
    "bmp_rle4_odd_absolute.bmp": True, "bmp24.bmp": False,
    "gif_transparent.gif": True, "gif_small_image.gif": True,
    "gif_small_image_transparent.gif": True, "gif.gif": False,
    "gif_index_past_table.gif": "none"}


@pytest.mark.parametrize("name", sorted(READER_DIFFERENCES))
def test_reader_difference_is_pinned(name):
    """Each difference between Pillow's and the JAX eval's bits has a
    fixture whose two digests differ (or agree, where the readers do), and
    the orientation of a TIFF is applied by both readers."""
    want = DIGESTS[f"coverage/{name}"]
    kind = READER_DIFFERENCES[name]
    assert want["opencv_none"] == (kind == "none")
    assert (want["sha256"] is None) == (kind == "pillow fails")
    assert (want["sha256"] != want["opencv_sha256"]) == (kind in (
        True, "pillow fails"))
    if name == "tiff_orientation6.tif":
        assert want["size"] == [20, 36]


def _open_info_file(key, compressed: bool) -> bytes:
    order, photo, fmt, fill, bps, extra = key
    g = np.random.default_rng(zlib.crc32(repr(key).encode()))
    S, b = len(bps), bps[0]
    img = (g.uniform(-20, 300, (11, 13, S)).astype(np.float32)
           if fmt[0] == 3 else g.integers(0, 1 << b, (11, 13, S)))
    cmap = list(g.integers(0, 65536, 3 << b)) if photo == 3 else None
    kw = dict(compression=5, predictor=2 if b in (8, 16, 32) else 1,
              rows_per_strip=4) if compressed else dict(rows_per_strip=3)
    return rf.tiff(img, order="<" if order == b"II" else ">",
                   photometric=photo, bps=bps, fmt=fmt[0], extra=extra,
                   fill=fill, colormap=cmap, **kw)


# the entries the port refuses where Pillow reads them (ROADMAP item 11c)
OPEN_INFO_REFUSED = {8: "CIELab"}


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "lzw"])
@pytest.mark.parametrize("key", list(TiffImagePlugin.OPEN_INFO),
                         ids=lambda k: "-".join(str(v) for v in k))
def test_open_info_kind_matches_both_readers(key, compressed, tmp_path):
    """A file of each ``TiffImagePlugin.OPEN_INFO`` entry: ``read_rgb``,
    ``read_raw`` and ``image_size`` equal to Pillow's (ValueError where
    Pillow raises), the eval reader to OpenCV's or Pillow's."""
    p = tmp_path / "x.tif"
    p.write_bytes(_open_info_file(key, compressed))
    try:
        want = _libraries(p)
    except (OSError, ValueError):      # Pillow refuses the file
        with pytest.raises(ValueError, match="x.tif"):
            image_io.read_rgb(p)
        return
    photo = key[1]
    if photo in OPEN_INFO_REFUSED:
        with pytest.raises(ValueError, match=OPEN_INFO_REFUSED[photo]):
            image_io.read_rgb(p)
        return
    rgb, raw, size, cv = want
    np.testing.assert_array_equal(image_io.read_rgb(p), rgb)
    got = image_io.read_raw(p)
    assert got.dtype == raw.dtype
    np.testing.assert_array_equal(got, raw, strict=False)
    assert rf.digest_raw(got) == rf.digest_raw(raw) or raw.dtype.kind == "f"
    assert image_io.image_size(p) == size
    np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"), cv)


@settings(max_examples=14, deadline=None, database=None)
@given(h=st.integers(1, 24), w=st.integers(1, 40),
       kind=st.sampled_from(["rgb", "grey", "grey16", "rgba"]),
       compression=st.sampled_from([5, 8, 32946, 32773]),
       predictor=st.booleans(), rows=st.integers(1, 24),
       order=st.sampled_from(["<", ">"]), seed=st.integers(0, 2 ** 16))
def test_tiff_sweep_matches_pillow(h, w, kind, compression, predictor, rows,
                                   order, seed, tmp_path_factory):
    """Compressed TIFF strips of random sizes, kinds, predictors and byte
    orders: the port equal to Pillow and to the JAX eval's reader."""
    g = np.random.default_rng(seed)
    photo, bits, S, extra = {"rgb": (2, 8, 3, ()), "grey": (1, 8, 1, ()),
                             "grey16": (1, 16, 1, ()),
                             "rgba": (2, 8, 4, (2,))}[kind]
    img = rf.scene(h, w, seed).astype(np.int64)
    img = np.concatenate([img, g.integers(0, 256, (h, w, 1))], -1)[..., :S]
    if bits == 16:
        img = img * 257 + g.integers(0, 257, img.shape)
    p = tmp_path_factory.mktemp("sweep") / "s.tif"
    p.write_bytes(rf.tiff(img, order=order, photometric=photo, bps=bits,
                          extra=extra, compression=compression,
                          predictor=2 if predictor else 1,
                          rows_per_strip=rows))
    rgb, raw, _, cv = _libraries(p)
    np.testing.assert_array_equal(image_io.read_rgb(p), rgb)
    np.testing.assert_array_equal(image_io.read_raw(p), raw)
    np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"), cv)


@settings(max_examples=10, deadline=None, database=None)
@given(h=st.integers(1, 30), w=st.integers(1, 40), runs=st.integers(1, 9),
       seed=st.integers(0, 2 ** 16))
def test_rle8_bmp_sweep_matches_pillow(h, w, runs, seed, tmp_path_factory):
    """RLE8 BMPs of random sizes and run lengths: both readers equal to
    Pillow and OpenCV, with the helper and the numpy reference."""
    g = np.random.default_rng(seed)
    idx = np.repeat(g.integers(0, 256, (h, -(-w // runs))), runs, 1)[:, :w]
    p = tmp_path_factory.mktemp("rle") / "r.bmp"
    p.write_bytes(rf.bmp(idx, 8, palette=g.integers(0, 256, (256, 3)),
                         compression=1, rle=rf.rle_encode(idx, 8)))
    rgb, raw, _, cv = _libraries(p)
    data = p.read_bytes()
    np.testing.assert_array_equal(image_io.read_rgb(p), rgb)
    np.testing.assert_array_equal(image_io.read_raw(p), raw)
    np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"), cv)
    for pillow in (True, False):
        status, px = image_io.bmp_rle_numpy(data, image_io._Bmp(
            data, "r").offset, 8, w, h, pillow)
        assert status == 0
        np.testing.assert_array_equal(px, idx[::-1])


def test_helper_loops_equal_their_references():
    """LZW (both bit orders), PackBits, the predictor and BMP RLE through
    the C++ helper equal to the numpy references on the same bytes."""
    assert image_io.host_build.load("raster_decode")
    g = np.random.default_rng(7)
    data = np.repeat(g.integers(0, 256, 3000), g.integers(1, 9, 3000)).astype(
        np.uint8).tobytes()
    for bits in (2, 5, 8):
        sym = bytes(b % (1 << bits) for b in data)
        coded = rf.lzw_encode(sym, None if bits == 8 else bits)
        lsb = bits != 8
        assert image_io.lzw_decode(coded, len(sym), "x", lsb, bits) == sym
        assert image_io.lzw_decode_numpy(coded, len(sym), lsb, bits,
                                         0 if lsb else 1) == sym
    coded = rf.packbits(data)
    assert image_io.packbits_decode(coded, len(data)) == data
    assert image_io.packbits_numpy(coded, len(data)) == data
    buf = g.integers(0, 256, (5, 48), dtype=np.uint8)
    for nbytes in (1, 2, 4):
        for order in "<>":
            np.testing.assert_array_equal(
                image_io.undifference(buf, 3, nbytes, order),
                image_io.undifference_numpy(buf, 3, nbytes, order))
    for name in ("bmp_rle8_delta.bmp", "bmp_rle4_odd_absolute.bmp",
                 "bmp_rle8_eol.bmp"):
        d = (ROOT / "coverage" / name).read_bytes()
        b = image_io._Bmp(d, name)
        for pillow in (True, False):
            got = image_io.bmp_rle(d, b.offset, b.bits, b.width, b.height,
                                   pillow)
            want = image_io.bmp_rle_numpy(d, b.offset, b.bits, b.width,
                                          b.height, pillow)
            assert got[0] == want[0] == 0
            np.testing.assert_array_equal(got[1], want[1])


def _refused():
    """(name, bytes, reader, what the message says) of every kind the port
    refuses; each one Pillow reads, or OpenCV, or neither."""
    rgb = rf.scene(9, 11, 3)
    g = np.random.default_rng(3)
    bi = rf._pillow(Image.fromarray(rgb[..., 0]).convert("1"), "TIFF",
                    compression="group4")
    out = [("g4.tif", bi, "pillow", "CCITT Group 4"),
           ("webp.tif", b"RIFF\0\0\0\0WEBPVP8 ", "pillow", "WebP"),
           ("lab.tif", rf.tiff(g.integers(0, 256, (9, 11, 3)), photometric=8,
                               bps=8), "pillow", "CIELab"),
           ("ycbcr_lzw_orientation3.tif", rf.ycbcr_tiff(
               rgb, 2, 2, compression=5, orientation=3), "pillow",
            "YCbCr"),
           ("ycbcr_planar.tif", rf.tiff(rgb, photometric=6, bps=8,
                                        planar=2, compression=5),
            "opencv", "planar"),
           ("la_planar_lzw.tif", rf.tiff(rgb[..., :2], photometric=1, bps=8,
                                         extra=(2,), planar=2,
                                         compression=5), "pillow",
            "planar"),
           ("la_tiled.tif", rf.tiff(rgb[..., :2], photometric=1, bps=8,
                                    extra=(2,), tile=(16, 16)), "opencv",
            "misplaces"),
           ("be_bigtiff.tif", rf.tiff(rgb, order=">", bigtiff=True,
                                      photometric=2, bps=8), "pillow",
            "BigTIFF"),
           ("bmp_alpha.bmp", rf.bmp(g.integers(0, 1 << 32, (4, 5),
                                               dtype=np.uint64), 32,
                                    compression=6, header=56,
                                    masks=[0xFF0000, 0xFF00, 0xFF,
                                           0xFF000000]), "pillow",
            "ALPHABITFIELDS"),
           ("bmp_png.bmp", rf.bmp(rgb[..., ::-1], 24, compression=5),
            "pillow", "PNG"),
           ("bmp_444.bmp", rf.bmp(g.integers(0, 1 << 16, (4, 5)), 16,
                                  compression=3, masks=[0xF00, 0xF0, 0xF]),
            "pillow", "bit fields"),
           ("nopal.gif", rf.gif(g.integers(0, 16, (4, 5))), "opencv",
            "colour table"),
           ("j2k.tif", b"\xffO\xffQ\x00\x29" + bytes(41), "pillow",
            "JPEG 2000")]
    old_jpeg = bytearray(rf.tiff(rgb, photometric=2, bps=8))
    i = old_jpeg.index(struct_tag(259, 1))
    old_jpeg[i:i + 10] = struct_tag(259, 6)
    out.append(("ojpeg.tif", bytes(old_jpeg), "pillow", "old-style JPEG"))
    for code, what in ((34925, "LZMA"), (50000, "ZSTD"), (50001, "WebP"),
                       (32809, "ThunderScan"), (34676, "SGILog")):
        t = bytearray(rf.tiff(rgb, photometric=2, bps=8))
        i = t.index(struct_tag(259, 1))
        t[i:i + 10] = struct_tag(259, code)
        out.append((f"c{code}.tif", bytes(t), "pillow", what))
    return out


def struct_tag(tag: int, value: int) -> bytes:
    import struct

    return struct.pack("<HHIH", tag, 3, 1, value)


@pytest.mark.parametrize("name,data,reader,what", _refused(),
                         ids=[r[0] for r in _refused()])
def test_refused_kind_raises_naming_the_file(name, data, reader, what,
                                             tmp_path):
    """Each kind the port does not read raises ValueError naming the file
    and the kind (ROADMAP items 11b and 11c list them)."""
    p = tmp_path / name
    p.write_bytes(data)
    with pytest.raises(ValueError, match=name) as e:
        image_io.read_rgb(p, reader=reader)
    assert what in str(e.value)


def test_big_endian_bigtiff_is_read_as_opencv_reads_it(tmp_path):
    """Pillow 12.1.0 does not open a big-endian BigTIFF, OpenCV does: the
    eval reader gives OpenCV's bits, the loader's raises."""
    p = tmp_path / "be.tif"
    p.write_bytes(rf.tiff(rf.scene(9, 11, 4), order=">", bigtiff=True,
                          photometric=2, bps=8, compression=5))
    with pytest.raises(OSError, match="cannot identify"):
        Image.open(p)
    np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"),
                                  cv2.imread(str(p), FLAGS)[..., ::-1])
    with pytest.raises(ValueError, match="BigTIFF"):
        image_io.read_raw(p)


def test_clip_loader_on_tiff_video_matches_jax():
    """The TIFF video through both packages' index, dataset and loader
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
    fixture as a one-frame clip and on an 8-frame clip of the TIFF
    video."""
    assert sys.modules[JRunner.__module__]._cv2 is not None
    runner = types.SimpleNamespace(image_root=None)
    files = sorted((ROOT / "coverage").iterdir()) + sorted(
        (ROOT / "timing").iterdir())
    assert len(files) == 82
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
    """``decode_tiff`` / ``decode_bmp`` / ``decode_gif`` on bytes equal
    ``read_rgb`` on the file."""
    for name, fn in (("tiff_rgb_lzw_pred2.tif", image_io.decode_tiff),
                     ("bmp_rle4.bmp", image_io.decode_bmp),
                     ("gif_transparent.gif", image_io.decode_gif)):
        p = ROOT / "coverage" / name
        for reader in ("pillow", "opencv"):
            np.testing.assert_array_equal(
                fn(p.read_bytes(), name, reader),
                image_io.read_rgb(p, reader=reader))
