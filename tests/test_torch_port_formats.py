"""The image kinds that the port's readers (``data/image_io.py``: the C++
helper ``csrc/jpeg_decode.cpp`` and the numpy reference
``jpeg_samples_numpy``, the PNG reader) decode beside baseline JPEG, held
to Pillow and OpenCV bit for bit on the CPU, and the tools of this slice
held to their JAX twins:

- the committed formats fixtures (``tests/jpeg_fixtures.py``
  ``generate_formats``: arithmetic-coded JPEG, sequential and progressive,
  grey, three and four components, restart intervals, DAC conditioning;
  lossless JPEG, predictors 1-7, point transforms, restart intervals,
  grey, RGB, CMYK, subsampled; CMYK and YCCK; 16-bit PNG of the four
  colour types, plain and Adam7; a CMYK arithmetic-coded video; 240x320
  timing frames) regenerated byte for byte, each checked independently
  of the port (an arithmetic-coded file decodes in Pillow as the Huffman
  file of its coefficients, a lossless file to its source samples);
- every fixture decoded by both to Pillow's ``convert("RGB")``, to
  OpenCV's ``imread`` (the eval's reader) and, for a PNG, to
  ``np.asarray(Image.open(f))`` (``read_raw``), against ``digests.json``
  and the libraries themselves;
- a hypothesis sweep of arithmetic-coded files against Pillow;
- the JAX ``COCOIndex`` / ``ClipLoader`` (Pillow) and the port's over the
  CMYK video; the JAX ``InferenceRunner._load_frames`` (OpenCV) and the
  port's over every fixture;
- the two EndoVis converters on the committed tree of 16-bit masks, and
  its JSON digest;
- the two checkpoint-converter CLIs on one synthetic ``.pt``: the same
  npz, key for key and bit for bit, which the port loads back as
  ``convert_checkpoint`` gave it.
"""

import io
import json
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import jpeg_fixtures as jf
from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.eval.inference import InferenceRunner as TRunner

cv2 = pytest.importorskip("cv2")
ROOT = jf.FORMATS
DIGESTS = json.loads((ROOT / "digests.json").read_text())
VIDEO = ROOT / "video"


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_regenerated_and_checked_independently(tmp_path):
    """``generate_formats`` writes the committed bytes again, and every
    file with a check passes it in Pillow alone."""
    checks = jf.generate_formats(tmp_path)
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in ROOT.rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path).as_posix()
                 for p in tmp_path.rglob("*") if p.is_file())
    assert got == [r for r in want if r != "endovis16.json.sha256"]
    for rel in got:
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    assert sum((ROOT / r).stat().st_size for r in want) <= 1024 * 1024
    kinds = {}
    for rel, check in checks.items():
        data = (ROOT / rel).read_bytes()
        if check is None:
            continue
        kind, ref = check
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "twin":
            assert ref[:2] == b"\xff\xd8" and b"\xff\xc4" in ref
            np.testing.assert_array_equal(_pillow(data), _pillow(ref),
                                          err_msg=rel)
        elif kind == "samples":
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))), ref, err_msg=rel)
        else:                      # png16: the samples or their high bytes
            raw = np.asarray(Image.open(io.BytesIO(data)))
            hi = (ref >> 8).astype(np.uint8)
            want_raw = (ref[..., 0] if ref.shape[-1] == 1 else
                        hi[..., [0, 0, 0, 1]] if ref.shape[-1] == 2 else hi)
            np.testing.assert_array_equal(raw, want_raw, err_msg=rel)
    assert kinds == {"twin": 40, "samples": 14, "png16": 8}


@pytest.mark.parametrize("helper", [True, False], ids=["native", "numpy"])
def test_fixtures_decode_to_their_digests(helper, monkeypatch):
    """Every formats fixture through the C++ helper and through the numpy
    reference: Pillow's ``convert("RGB")`` (the loader), OpenCV's
    ``imread`` where it reads the file, else Pillow's (the eval), and for
    a PNG ``np.asarray(Image.open(f))`` (``read_raw``); each equal to its
    digest and to the library itself."""
    if helper:
        assert image_io.host_build.load("jpeg_decode"), \
            "the C++ JPEG decoder did not build"
    else:
        monkeypatch.setattr(image_io, "_helpers", {"jpeg_decode": None})
    assert len(DIGESTS) == len([p for p in ROOT.rglob("*")
                                if p.suffix in (".jpg", ".png")
                                and "endovis16" not in p.parts]) == 72
    no_cv = []
    for rel, want in DIGESTS.items():
        p = ROOT / rel
        data = p.read_bytes()
        if p.suffix == ".jpg":
            samples = (image_io.jpeg_samples_numpy(data, rel) if not helper
                       else None)
            got = (image_io._rgb(samples, "pillow") if not helper
                   else image_io.read_rgb(p))
            cv = (image_io._rgb(samples, "opencv") if not helper
                  else image_io.read_rgb(p, reader="opencv"))
        else:
            got = image_io.read_rgb(p)
            cv = image_io.read_rgb(p, reader="opencv")
            raw = image_io.read_raw(p)
            want_raw = np.asarray(Image.open(p))
            assert raw.dtype == want_raw.dtype, rel
            assert [list(raw.shape), str(raw.dtype)] == [
                want["raw_shape"], want["raw_dtype"]], rel
            assert jf.digest_raw(raw) == want["raw_sha256"], rel
            np.testing.assert_array_equal(raw, want_raw, err_msg=rel)
        assert list(got.shape) == want["shape"], rel
        assert jf.digest(got) == want["sha256"], rel
        assert jf.digest(cv) == (want["opencv_sha256"] or want["sha256"]), rel
        if not helper or "video/" in rel:
            continue
        np.testing.assert_array_equal(got, _pillow(data), err_msg=rel)
        ocv = cv2.imread(str(p), cv2.IMREAD_COLOR
                         | cv2.IMREAD_IGNORE_ORIENTATION)
        if ocv is None:
            no_cv.append(rel)
        else:
            np.testing.assert_array_equal(cv, ocv[..., ::-1], err_msg=rel)
    # imread reads every kind but lossless grey (it asks libjpeg for BGR,
    # which lossless mode does not convert to)
    assert no_cv == ([f"coverage/lossless_grey_p{p}.jpg" for p in range(1, 8)]
                     if helper else [])


@settings(max_examples=12, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       quality=st.integers(5, 100),
       sampling=st.sampled_from([(1, 1), (2, 1), (1, 2), (2, 2)]),
       comps=st.sampled_from([1, 3, 4]), restart=st.sampled_from([0, 1, 3]),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_arithmetic_sweep_matches_pillow(h, w, quality, sampling, comps,
                                         restart, progressive, seed):
    """Arithmetic-coded files of random sizes, qualities, samplings,
    component counts, restart intervals and processes: both decoders equal
    to Pillow, and Pillow equal on the Huffman file of the same
    coefficients."""
    img = jf._scene(h, w, seed)
    planes = {1: [img[..., 0]], 3: jf.ycc(img), 4: jf.cmyk(img)}[comps]
    samp = [sampling] + [(1, 1)] * (comps - 1)
    coded = jf.quantise(planes, samp, jf._tables(quality),
                        [0, 1, 1, 0][:comps],
                        apps=jf.adobe(0) if comps == 4 else jf.JFIF)
    data = jf.arithmetic_jpeg(coded, restart=restart,
                              progressive=progressive)
    want = _pillow(data)
    np.testing.assert_array_equal(want, _pillow(jf.huffman_jpeg(coded)))
    np.testing.assert_array_equal(image_io.decode_jpeg(data), want)
    np.testing.assert_array_equal(image_io.decode_jpeg_numpy(data), want)


def test_clip_loader_on_cmyk_video_matches_jax():
    """The CMYK arithmetic-coded video through both packages' index,
    dataset and loader (JAX: Pillow; port: its decoder), frames at 64 px
    and every field of every batch equal."""
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


def test_inference_frames_match_jax(tmp_path):
    """``InferenceRunner._load_frames`` of both packages (JAX: OpenCV's
    ``imread``, Pillow where it returns None) on every coverage and timing
    fixture as a one-frame clip, on PNGs of every mode Pillow writes (1,
    L, LA, P at 8, 4 and 2 bits, RGB, RGBA, and I;16), and on an 8-frame
    clip of the CMYK video."""
    assert sys.modules[JRunner.__module__]._cv2 is not None
    runner = types.SimpleNamespace(image_root=None)
    files = sorted(p for p in (ROOT / "coverage").iterdir()) + sorted(
        (ROOT / "timing").iterdir())
    assert len(files) == 56
    rgb = Image.fromarray(jf._scene(29, 41, 25))
    for i, im in enumerate((rgb, rgb.convert("RGBA"), rgb.convert("L"),
                            rgb.convert("LA"), rgb.convert("P"),
                            rgb.quantize(12), rgb.quantize(3),
                            rgb.convert("1"), Image.fromarray(   # I;16
                                np.asarray(rgb)[..., 0].astype(np.uint16)
                                * 257))):
        im.save(tmp_path / f"{i}.png")
        files.append(tmp_path / f"{i}.png")
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


def test_endovis16_tree_converts_as_jax(tmp_path, monkeypatch):
    """The committed EndoVis tree with 16-bit class-id masks (ids 256 to
    65535): the port's converter CLI writes the JAX converter's JSON, byte
    for byte, from the repository root, whose sha256 is committed."""
    import hashlib

    sys.path.insert(0, str(jf.REPO / "data_tools"))
    import convert_endovis_to_coco as jtool
    import convert_endovis_to_coco_torch as ttool

    src = (ROOT / "endovis16").relative_to(jf.REPO)
    monkeypatch.chdir(jf.REPO)
    jtool.convert(str(src), str(tmp_path / "jax.json"), 2)
    ttool.main([str(src), str(tmp_path / "port.json"), "--n-jobs", "2"])
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert hashlib.sha256(got).hexdigest() == (
        ROOT / "endovis16.json.sha256").read_text().strip()
    data = json.loads(got)
    cats = {a["category_id"] for a in data["annotations"]}
    assert cats == {1, 2, 3, 4} and len(data["images"]) == 6
    mask = ROOT / "endovis16" / "annotations" / "seq_3_frame000.png"
    raw = image_io.read_raw(mask)
    assert raw.dtype == np.uint16 and raw.max() == 65535
    np.testing.assert_array_equal(raw, np.asarray(Image.open(mask)))


def test_converter_clis_write_the_same_npz(tmp_path, capsys, monkeypatch):
    """A Meta-style ``{"model": state_dict}`` checkpoint of the port's
    SAM2-tiny init: the JAX CLI (``python -m
    sam2_video_tpu.training.convert``) and the port's write npz files with
    the same keys and arrays, bit for bit, and the same report line; the
    port's ``load_params_npz`` of that file equals its
    ``convert_checkpoint``. The conversion is strict, so every array comes
    from the checkpoint and the template's values do not matter: the JAX
    side's template is zeros of its init's shapes (``jax.eval_shape``),
    which spares its eager random init (~20 s on the CPU)."""
    import jax

    from sam2_video_tpu.training import convert as jconvert
    from sam2_video_tpu_torch.models import sam2 as sam2_mod
    from sam2_video_tpu_torch.training import checkpoint as tckpt
    from sam2_video_tpu_torch.training import convert as tconvert

    jinit = jconvert.sam2_mod.init

    def zeros(key, cfg):
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                            jax.eval_shape(lambda: jinit(key, cfg)))

    monkeypatch.setattr(jconvert.sam2_mod, "init", zeros)
    params = sam2_mod.init(sam2_mod.SAM2Config(backbone="tiny",
                                               image_size=128), seed=3)
    sd = {k: v.detach().clone() for k, v in params.named_parameters()}
    torch.save({"model": sd}, tmp_path / "ckpt.pt")
    args = [str(tmp_path / "ckpt.pt"), "--image-size", "128"]
    monkeypatch.setattr(sys, "argv", ["convert", args[0],
                                      str(tmp_path / "jax.npz"), *args[1:]])
    jconvert.main()
    jax_line = capsys.readouterr().out
    tconvert.main([args[0], str(tmp_path / "port.npz"), *args[1:]])
    port_line = capsys.readouterr().out
    assert port_line.replace("port.npz", "jax.npz") == jax_line
    assert "0 missing, 0 unexpected" in port_line
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path /
                                                     "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    loaded = tckpt.load_params_npz(tmp_path / "port.npz")
    converted, _ = tconvert.convert_checkpoint(tmp_path / "ckpt.pt",
                                               image_size=128)
    assert sorted(loaded) == sorted(converted)
    for k, v in converted.items():
        assert torch.equal(loaded[k], v), k
