"""The port's data layer held against the JAX package's on the CPU, bit for
bit: the RLE codecs, the PNG reader and Pillow's resizes (the port has no
Pillow: ``data/image_io.py``), the object cut of the prompts (the port has
no OpenCV: ``utils/prompts.py`` on scipy), ``COCOIndex`` frames and masks,
``ClipDataset`` / ``ClipLoader`` batches and ``make_synthetic_dataset``.
The JAX side runs with Pillow and OpenCV, as it does on a host that has
them.
"""

import io
import json
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.data import rle as jrle
from sam2_video_tpu.data import synthetic as jsyn
from sam2_video_tpu.utils import prompts as jprompts
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data import rle as trle
from sam2_video_tpu_torch.data import synthetic as tsyn
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.utils import prompts as tprompts

cv2 = pytest.importorskip("cv2")


def _masks(seed: int, n: int = 12):
    """Seeded masks: random noise, smooth blobs, all zero and all one, in
    odd sizes."""
    g = np.random.default_rng(seed)
    out = [np.zeros((7, 9), np.uint8), np.ones((5, 3), np.uint8)]
    for i in range(n):
        h, w = g.integers(3, 70, 2)
        if i % 2:
            m = g.random((h, w)) > 0.6
        else:
            m = ndimage.gaussian_filter(g.random((h, w)), 2.0) > 0.5
        out.append(m.astype(np.uint8))
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_rle_matches_jax(native, monkeypatch):
    """encode / decode / area / to_bbox / merge_or / iou against the JAX
    codec, with the port's C++ codec and with its numpy codec."""
    if native:
        assert trle.rle_native.load(), "the C++ RLE codec did not build"
    monkeypatch.setattr(trle, "NATIVE_AVAILABLE", native)
    masks = _masks(1)
    for m in masks:
        rj, rt = jrle.encode(m), trle.encode(m)
        assert rt == rj
        np.testing.assert_array_equal(trle.decode(rj), jrle.decode(rj))
        np.testing.assert_array_equal(trle.decode(rt), m)
        assert trle.area(rj) == jrle.area(rj) == int(m.sum())
        assert trle.to_bbox(rj) == jrle.to_bbox(rj)
        counts = jrle.decode_counts(rj["counts"])
        np.testing.assert_array_equal(trle.decode_counts(rj["counts"]),
                                      counts)
        assert trle.encode_counts(counts) == rj["counts"]
        uncompressed = {"size": rj["size"], "counts": counts.tolist()}
        np.testing.assert_array_equal(trle.decode(uncompressed), m)
    same = [m for m in masks if m.shape == masks[2].shape] + [
        (np.random.default_rng(s).random(masks[2].shape) > 0.5).astype(
            np.uint8) for s in range(3)]
    rles = [jrle.encode(m) for m in same]
    np.testing.assert_array_equal(trle.merge_or(rles), jrle.merge_or(rles))
    for a in rles:
        for b in rles:
            assert trle.iou(a, b) == jrle.iou(a, b)


def _pillow_png(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _filter_types(png: bytes) -> set:
    """The row filter types a PNG file uses."""
    w, h, depth, ctype = struct.unpack(">IIBB", png[16:26])
    idat, pos = b"", 8
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            idat += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


def _images():
    g = np.random.default_rng(2)
    H, W = 41, 67
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([xx * 3 % 256, yy * 5 % 256, (xx * yy) % 256],
                      -1).astype(np.uint8)
    return smooth, g.integers(0, 256, (H, W, 3), dtype=np.uint8)


def _adam7_png(img: np.ndarray, depth: int = 8, palette=None) -> bytes:
    """An Adam7-interlaced PNG (Pillow writes none): uint8 [H, W] grey or
    palette indices (at ``depth`` bits, with ``palette`` for a palette
    image) or [H, W, 3] RGB; each pass's rows filtered with type 1
    (Sub) and packed as the PNG spec says."""
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = 3 if palette is not None else (0 if ch == 1 else 2)
    body = b""
    for x0, y0, dx, dy in image_io.ADAM7:
        part = img[y0::dy, x0::dx]
        if not part.size:
            continue
        h, w = part.shape[:2]
        if depth < 8:
            bits = ((part[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
            rows = np.packbits(bits.reshape(h, w * depth).astype(np.uint8),
                               axis=1)
            bpp = 1
        else:
            rows = part.reshape(h, w * ch)
            bpp = ch
        body += image_io._filter_rows(rows, np.ones(h, np.int64),
                                      bpp).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    plte = (chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
            if palette is not None else b"")
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, 1))
            + plte + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND",
                                                                 b""))


def test_png_reader_matches_pillow():
    """Files that Pillow writes in every mode the reader takes, RGB, RGBA,
    L, LA, P (8, 4 and 2 bits) and 1, then the port's own files with each
    row's filter drawn at random: read equal to Pillow's ``convert("RGB")``;
    the C++ unfilter equal to its numpy reference. Pillow's encoder picks
    each row's filter among None, Sub, Up and Paeth (those four occur over
    the set) and never Average, which the port's files cover. Then
    Adam7-interlaced files (RGB, grey at 8, 4, 2 and 1 bits, palette at 8
    and 2 bits), in odd sizes that leave some of the seven passes empty,
    against Pillow, and ``read_raw`` against ``np.asarray(Image.open())``
    on every file of a mode it reads."""
    used = set()
    for arr in _images():
        rgb = Image.fromarray(arr)
        for im in (rgb, rgb.convert("RGBA"), rgb.convert("L"),
                   rgb.convert("LA"), rgb.convert("P"), rgb.quantize(12),
                   rgb.quantize(3), rgb.convert("1")):
            png = _pillow_png(im)
            used |= _filter_types(png)
            want = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
            np.testing.assert_array_equal(image_io.decode_png(png), want,
                                          err_msg=im.mode)
    assert used == {0, 1, 2, 4}
    g = np.random.default_rng(3)
    for arr in _images():
        for img in (arr, arr[..., 0], np.dstack([arr, arr[..., :1]])):
            filters = g.integers(0, 5, img.shape[0])
            png = image_io.encode_png(img, filters)
            assert _filter_types(png) == {0, 1, 2, 3, 4}
            want = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
            np.testing.assert_array_equal(image_io.decode_png(png), want)
            ch = 1 if img.ndim == 2 else img.shape[-1]
            raw = np.frombuffer(zlib.decompress(png[41:-12]), np.uint8)
            h, stride = img.shape[0], img.shape[1] * ch
            np.testing.assert_array_equal(
                image_io.unfilter(raw, h, stride, ch),
                image_io.unfilter_numpy(raw, h, stride, ch))
    pal = g.integers(0, 256, (256, 3))
    for H, W in ((41, 67), (3, 2), (1, 9), (9, 1), (5, 5)):
        arr = g.integers(0, 256, (H, W, 3), dtype=np.uint8)
        files = [_adam7_png(arr), _adam7_png(arr[..., 0])]
        files += [_adam7_png(arr[..., 0] >> (8 - d), d) for d in (4, 2, 1)]
        files += [_adam7_png(arr[..., 1], 8, pal),
                  _adam7_png(arr[..., 1] >> 6, 2, pal[:4])]
        for png in files:
            assert png[28] == 1                       # interlaced
            want = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
            np.testing.assert_array_equal(image_io.decode_png(png), want)


def test_read_raw_and_image_size_match_pillow(tmp_path):
    """``read_raw`` equals ``np.asarray(Image.open(p))`` (values and dtype)
    for Pillow's files in modes 1, L, LA, P (8, 4 and 2 bits), RGB and
    RGBA, the port's own 2- and 4-bit grey and interlaced files; and
    ``image_size`` equals ``Image.open(p).size`` for them and for a JPEG."""
    arr = _images()[0]
    rgb = Image.fromarray(arr)
    files = {f"{i}.png": _pillow_png(im) for i, im in enumerate(
        (rgb, rgb.convert("RGBA"), rgb.convert("L"), rgb.convert("LA"),
         rgb.convert("P"), rgb.quantize(12), rgb.quantize(3),
         rgb.convert("1")))}
    files["grey4.png"] = _adam7_png(arr[..., 0] >> 4, 4)
    files["grey2.png"] = _adam7_png(arr[..., 0] >> 6, 2)
    files["inter.png"] = _adam7_png(arr)
    jpeg = io.BytesIO()
    rgb.save(jpeg, "JPEG")
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        want = np.asarray(Image.open(tmp_path / name))
        got = image_io.read_raw(tmp_path / name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert image_io.image_size(tmp_path / name) == Image.open(
            tmp_path / name).size
    (tmp_path / "a.jpg").write_bytes(jpeg.getvalue())
    assert image_io.image_size(tmp_path / "a.jpg") == (67, 41)


def test_png_reader_rejects_what_it_cannot_read(tmp_path):
    """A palette PNG of bit depth 16 (not valid), a 12-bit JPEG, an
    arithmetic-coded lossless JPEG (a baseline file with its SOF0 marker
    made SOF11: libjpeg, and so Pillow, decodes none) and a text file
    raise ValueError naming the file and what it is."""
    smooth, _ = _images()
    jpeg = io.BytesIO()
    Image.fromarray(smooth).save(jpeg, "JPEG")
    data = jpeg.getvalue()
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    pal16 = bytearray(image_io.encode_png(smooth[..., 0]))
    pal16[24:26] = bytes([16, 3])                 # IHDR depth, colour type
    pal16[29:33] = struct.pack(">I", zlib.crc32(bytes(pal16[12:29])))
    cases = {"deep.png": (bytes(pal16), "palette PNG of bit depth 16"),
             "twelve.jpg": (bytes(twelve), "12-bit"),
             "sof11.jpg": (data[:sof] + b"\xff\xcb" + data[sof + 2:],
                           "arithmetic-coded lossless"),
             "notes.png": (b"hello", "not a PNG")}
    for name, (data, what) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=what) as err:
            image_io.read_rgb(tmp_path / name)
        assert name in str(err.value)


def test_unfilter_without_the_helper_warns_once(monkeypatch):
    """When the C++ unfilter cannot be built, ``unfilter`` says so once
    with a RuntimeWarning and decodes with the numpy reference."""
    monkeypatch.setattr(image_io, "_helpers", {})
    monkeypatch.setattr(image_io.host_build, "load", lambda name: None)
    img = _images()[0]
    png = image_io.encode_png(img, np.arange(img.shape[0]) % 5)
    want = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    with pytest.warns(RuntimeWarning, match="numpy unfilter"):
        np.testing.assert_array_equal(image_io.decode_png(png), want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(image_io.decode_png(png), want)


@pytest.mark.parametrize("src,dst", [
    ((480, 854), (683, 384)), ((480, 854), (384, 384)),
    ((240, 320), (512, 384)), ((240, 320), (96, 72)),
    ((97, 131), (384, 285)), ((97, 131), (17, 13)), ((5, 3), (4, 7)),
    ((384, 384), (384, 384))])
def test_resize_matches_pillow(src, dst):
    """BILINEAR (``Resample.c``'s 22-bit fixed point, horizontal pass first)
    and NEAREST (the affine scale's accumulated source coordinate) bit for
    bit against Pillow, down and up, on noise and smooth RGB frames and on
    a 0 / 255 mask."""
    g = np.random.default_rng(sum(src) + sum(dst))
    H, W = src
    yy, xx = np.mgrid[0:H, 0:W]
    frames = [g.integers(0, 256, (H, W, 3), dtype=np.uint8),
              np.stack([xx * 255 // max(W - 1, 1), yy * 255 // max(H - 1, 1),
                        (xx + yy) % 256], -1).astype(np.uint8)]
    for f in frames:
        im = Image.fromarray(f)
        np.testing.assert_array_equal(image_io.resize_bilinear(f, dst),
                                      np.asarray(im.resize(dst,
                                                           Image.BILINEAR)))
        np.testing.assert_array_equal(image_io.resize_nearest(f, dst),
                                      np.asarray(im.resize(dst,
                                                           Image.NEAREST)))
    m = (g.random((H, W)) > 0.5).astype(np.uint8) * 255
    np.testing.assert_array_equal(
        image_io.resize_nearest(m, dst),
        np.asarray(Image.fromarray(m).resize(dst, Image.NEAREST)))


def _blob_masks():
    """Seeded blob masks with touching, diagonal, thin and border cases."""
    g = np.random.default_rng(4)
    out = []
    m = np.zeros((40, 48), np.uint8)
    m[5:15, 5:15] = 1
    m[15:25, 15:25] = 1                      # touches the first diagonally
    m[30:32, 2:46] = 1                        # thin: the opening removes it
    m[0:8, 38:48] = 1                         # on the border
    out.append(m)
    m = np.zeros((33, 35), np.uint8)
    m[1:12, 1:12] = m[1:12, 14:25] = 1        # side by side, same rows
    m[2:13, 26:34] = 1
    m[20:33, 0:35] = 1
    m[24:28, 10:20] = 0
    out.append(m)
    for i in range(14):
        h, w = g.integers(20, 90, 2)
        sigma = g.uniform(1.0, 3.5)
        out.append((ndimage.gaussian_filter(g.random((h, w)), sigma)
                    > g.uniform(0.45, 0.55)).astype(np.uint8))
    return out


def test_connected_components_match_cv2():
    """The 5x5 ellipse equals cv2's; find_connected_components equals the
    JAX package's (cv2 opening and 8-connected labels, in cv2's order) on
    every blob mask; and cv2's order is not plain raster order on some of
    them, which the block order of ``label_components`` reproduces."""
    assert jprompts._HAS_CV2
    ellipse = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    np.testing.assert_array_equal(tprompts.ELLIPSE_5X5, ellipse.astype(bool))
    raster_differs = 0
    for m in _blob_masks():
        want = jprompts.find_connected_components(m)
        got = tprompts.find_connected_components(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        raster, _ = ndimage.label(tprompts.open_ellipse(m), np.ones((3, 3)))
        _, labels = cv2.connectedComponents(
            tprompts.open_ellipse(m).astype(np.uint8))
        raster_differs += not np.array_equal(raster, labels)
    assert raster_differs > 0


def test_prompts_match_jax():
    """cat_to_obj_masks (with the cap dropping the smallest), point prompts
    with centre, positives and negatives, box prompts, noised boxes and
    both correction-click samplers against the JAX functions, each from
    the same seed."""
    masks = _blob_masks()[2:10]
    cats = np.stack([m[:20, :20] for m in masks if min(m.shape) >= 20])
    for cap in (3, 8, 40):
        for a, b in zip(tprompts.cat_to_obj_masks(cats, cap),
                        jprompts.cat_to_obj_masks(cats, cap)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no objects"):
        tprompts.cat_to_obj_masks(np.zeros((2, 9, 9)), 4)
    objs, _ = jprompts.cat_to_obj_masks(cats, 8)
    for args in ((1, 0, True), (2, 3, True), (3, 1, False)):
        for a, b in zip(
                tprompts.generate_point_prompt(objs, *args,
                                               np.random.default_rng(7)),
                jprompts.generate_point_prompt(objs, *args,
                                               np.random.default_rng(7))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tprompts.generate_box_prompt(objs),
                    jprompts.generate_box_prompt(objs)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tprompts.sample_box_points(objs, np.random.default_rng(8)),
                    jprompts.sample_box_points(objs,
                                               np.random.default_rng(8))):
        np.testing.assert_array_equal(a, b)
    pred = np.roll(objs, 3, axis=-1)
    for method in ("uniform", "center"):
        for a, b in zip(
                tprompts.get_next_point(objs, pred, method,
                                        np.random.default_rng(9)),
                jprompts.get_next_point(objs, pred, method,
                                        np.random.default_rng(9))):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    return jsyn.make_synthetic_dataset(root, num_videos=2,
                                       frames_per_video=6,
                                       image_hw=(120, 214),
                                       num_categories=3, seed=1)


@pytest.mark.parametrize("cache_mb", [0.0, 1.0])
def test_coco_index_matches_jax(dataset, cache_mb):
    """Frames (uint8 and normalised) and masks of every image at 96 px
    equal the JAX index's; with a frame cache, twice, read-only, and at
    most the budget's entries kept."""
    j = jcoco.COCOIndex(dataset, 96)
    t = tcoco.COCOIndex(dataset, 96, frame_cache_mb=cache_mb)
    assert t.video_to_images == j.video_to_images
    assert t.catid_to_idx == j.catid_to_idx
    for _ in range(2):
        for i, im in enumerate(j.images):
            raw = t.load_image(i, normalize=False)
            np.testing.assert_array_equal(raw, j.load_image(i,
                                                            normalize=False))
            np.testing.assert_array_equal(t.load_image(i), j.load_image(i))
            np.testing.assert_array_equal(t.load_masks(im["id"]),
                                          j.load_masks(im["id"]))
            assert raw.flags.writeable == (cache_mb == 0)
    assert len(t._frame_cache) * 96 * 96 * 3 <= cache_mb * 2 ** 20
    assert tcoco.clip_windows(t, 4, 2) == jcoco.clip_windows(j, 4, 2)


def test_coco_index_fails_fast_on_empty_categories(tmp_path):
    p = tmp_path / "a.json"
    p.write_text(json.dumps({"images": [], "annotations": [],
                             "categories": []}))
    with pytest.raises(ValueError, match="categories"):
        tcoco.COCOIndex(p, 64)


@pytest.mark.parametrize("prompt", ["point", "box"])
def test_clip_loader_matches_jax(dataset, prompt):
    """ClipDataset.get, and two epochs of ClipLoader batches of two shards
    (process_count=2) with shuffling, equal to the JAX pipeline's: every
    field, dtype and value (the port's batches are CPU tensors)."""
    cfg = dict(clip_length=3, stride=2, prompt_type=prompt, max_objects=4,
               num_pos_points=2, num_neg_points=1)
    jds = jpipe.ClipDataset(jcoco.COCOIndex(dataset, 64),
                            jpipe.ClipDatasetConfig(**cfg))
    tds = tpipe.ClipDataset(tcoco.COCOIndex(dataset, 64),
                            tpipe.ClipDatasetConfig(**cfg))
    assert len(tds) == len(jds) == 4
    for i in range(len(jds)):
        a = tds.get(i, np.random.default_rng(i))
        b = jds.get(i, np.random.default_rng(i))
        for k in FIELDS:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for shard in range(2):
        kw = dict(batch_size=1, seed=5, process_index=shard, process_count=2)
        tl, jl = tpipe.ClipLoader(tds, **kw), jpipe.ClipLoader(jds, **kw)
        for _ in range(2):
            n = 0
            for tb, jb in zip(tl, jl, strict=True):
                for k in FIELDS:
                    x, y = getattr(tb, k).numpy(), np.asarray(getattr(jb, k))
                    assert x.dtype == y.dtype, k
                    np.testing.assert_array_equal(x, y)
                n += 1
            assert n == len(tl) == 2


def test_synthetic_dataset_matches_jax(tmp_path):
    """Both writers into one directory in turn: the same JSON text and the
    same pixels (the port's PNGs use filter 0)."""
    kw = dict(num_videos=2, frames_per_video=3, image_hw=(96, 128),
              num_categories=4, seed=3)
    jpath = jsyn.make_synthetic_dataset(tmp_path, **kw)
    jtext = jpath.read_text()
    images = json.loads(jtext)["images"]
    jpix = [np.asarray(Image.open(im["path"]).convert("RGB"))
            for im in images]
    tpath = tsyn.make_synthetic_dataset(tmp_path, **kw)
    assert tpath == jpath and tpath.read_text() == jtext
    for im, want in zip(images, jpix):
        assert _filter_types(open(im["path"], "rb").read()) == {0}
        np.testing.assert_array_equal(image_io.read_rgb(im["path"]), want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(im["path"]).convert("RGB")), want)
