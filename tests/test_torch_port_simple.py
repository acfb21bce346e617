"""The port's readers of the simple formats that ffmpeg writes
(``data/simple_formats.py``: Netpbm, PAM, PFM, Sun raster, TGA, SGI, PCX,
DCX, QOI, XBM, Radiance HDR, DIB; the C++ helper
``csrc/simple_decode.cpp`` and the numpy references beside it) held to
Pillow and OpenCV bit for bit on the CPU, and the frames they read held to
the JAX package's readers:

- the committed fixtures (``tests/simple_fixtures.py``) regenerated byte
  for byte, each read to its digests of Pillow's ``convert("RGB")`` (the
  JAX loader), the JAX eval's reader (OpenCV's ``imread``, else Pillow)
  and ``np.asarray(Image.open(f))`` and to its size, with the helper and
  with the numpy references, and to the libraries themselves;
- the format the port picks equal to the plugin Pillow's fresh-process
  order picks, on every fixture;
- each run-length and op loop of the helper against its reference;
- a hypothesis sweep of Pillow-written files against Pillow and OpenCV;
- truncated and corrupt files raise ``ValueError`` naming the file and
  the kind;
- the JAX ``COCOIndex`` / ``ClipLoader`` (Pillow) and the port's over the
  mixed-format video; the JAX ``InferenceRunner._load_frames`` (OpenCV,
  else Pillow) and the port's over every fixture.
"""

import itertools
import json
import struct
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import raster_fixtures as rf
import simple_fixtures as sfx
from sam2_video_tpu.data import coco as jcoco
from sam2_video_tpu.data import pipeline as jpipe
from sam2_video_tpu.eval.inference import InferenceRunner as JRunner
from sam2_video_tpu_torch.data import coco as tcoco
from sam2_video_tpu_torch.data import image_io
from sam2_video_tpu_torch.data import pipeline as tpipe
from sam2_video_tpu_torch.data import simple_formats as sf
from sam2_video_tpu_torch.data.types import FIELDS
from sam2_video_tpu_torch.eval.inference import InferenceRunner as TRunner

cv2 = pytest.importorskip("cv2")
ROOT = sfx.SIMPLE
DIGESTS = json.loads((ROOT / "digests.json").read_text())
COVERAGE = sorted((ROOT / "coverage").iterdir())
VIDEO = ROOT / "video"
FLAGS = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
# the order Image.open tries the plugins in, in a process that imported
# PIL.Image alone: preinit's six, then the rest of init's
FRESH_ORDER = [
    "BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR",
    "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5",
    "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF",
    "MSP", "PCD", "PIXAR", "PSD", "QOI", "SGI", "SPIDER", "SUN", "TGA",
    "WEBP", "WMF", "XBM", "XPM", "XVTHUMB"]


@pytest.fixture(params=["native", "numpy"])
def helpers(request, monkeypatch):
    """The C++ helper, which must build, or the numpy references."""
    if request.param == "native":
        assert image_io.host_build.load("simple_decode"), \
            "the C++ simple-format helper did not build"
    else:
        monkeypatch.setattr(image_io, "_helpers", {"simple_decode": None})
    return request.param


def _attempt(fn):
    try:
        return fn()
    except ValueError:
        return None


def test_regenerated_byte_for_byte(tmp_path):
    """``simple_fixtures.generate`` writes the committed bytes again, and
    the folder stays small."""
    sfx.generate(tmp_path)
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in ROOT.rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path).as_posix()
                 for p in tmp_path.rglob("*") if p.is_file())
    assert got == want
    for rel in got:
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    assert sum((ROOT / r).stat().st_size for r in want) < 1300 * 1024
    assert max(p.stat().st_size for p in COVERAGE) < 16 * 1024


def test_fixtures_read_to_their_digests(helpers):
    """Every fixture through ``read_rgb`` (both readers), ``read_raw`` and
    ``image_size``: equal to its digests (``ValueError`` where they are
    null), and the coverage files to Pillow and OpenCV themselves (the
    numpy references read the coverage files)."""
    assert len(DIGESTS) == 125
    for rel, want in DIGESTS.items():
        if helpers == "numpy" and not rel.startswith("coverage/"):
            continue
        p = ROOT / rel
        rgb = _attempt(lambda: image_io.read_rgb(p))
        cv = _attempt(lambda: image_io.read_rgb(p, reader="opencv"))
        raw = _attempt(lambda: image_io.read_raw(p))
        size = _attempt(lambda: list(image_io.image_size(p)))
        assert size == want["size"], rel
        assert (rgb is None) == (want["sha256"] is None), rel
        assert (cv is None) == (want["opencv_sha256"] is None), rel
        assert (raw is None) == (want["raw_sha256"] is None), rel
        if rgb is not None:
            assert rf.digest(rgb) == want["sha256"], rel
            assert [list(raw.shape), raw.dtype.str] == [want["raw_shape"],
                                                        want["raw_dtype"]]
            assert rf.digest_raw(raw) == want["raw_sha256"], rel
        if cv is not None:
            assert rf.digest(cv) == want["opencv_sha256"], rel
        if helpers == "numpy" or not rel.startswith("coverage/"):
            continue
        lib_cv = cv2.imread(str(p), FLAGS)
        if lib_cv is not None:
            np.testing.assert_array_equal(cv, lib_cv[..., ::-1], err_msg=rel)
        if rgb is not None:
            with Image.open(p) as im:
                assert image_io.image_size(p) == im.size
                np.testing.assert_array_equal(rgb, np.asarray(
                    im.convert("RGB")), err_msg=rel)


def test_readers_differ_where_the_module_says():
    """The kinds on which Pillow's and the JAX eval's bits differ are the
    ones ``simple_formats`` lists: Netpbm of maxval other than 255, PAM,
    ``PF``, HDR and 1- and 32-bit Sun; the video's frames agree."""
    differ = {rel.split("/")[1].split(".")[0] for rel, d in DIGESTS.items()
              if d["sha256"] != d["opencv_sha256"]}
    assert differ == {
        "p2_ascii_maxval100", "p2_ascii_maxval65535", "p3_ascii_maxval1000",
        "p5_maxval1", "p5_maxval100", "p5_maxval1000", "p5_maxval65535",
        "p6_maxval100", "p6_maxval1000", "p6_maxval65535", "pam_rgb_opencv",
        "pam_grayscale_opencv", "pam_no_tupltype_rgb", "pam_rgb16",
        "pam_grayscale_maxval100", "pam_grayscale_alpha_w1",
        "pam_rgb_alpha_w1", "pam_blackandwhite", "pF_little",
        "pF_big_scale4", "pF_opencv", "hdr_rle", "hdr_flat",
        "hdr_old_runs", "hdr_rgbe_magic", "hdr_narrow", "hdr_opencv",
        "sun_1_standard", "sun_1_colour_map", "sun_32_standard"}
    for rel, d in DIGESTS.items():
        if rel.startswith("video/"):
            assert d["sha256"] == d["opencv_sha256"] and d["sha256"], rel


@pytest.mark.parametrize("path", COVERAGE + sorted((ROOT / "timing")
                                                    .iterdir()),
                         ids=lambda p: p.name)
def test_port_picks_pillows_plugin(path):
    """``Image.open`` in the fresh-process plugin order opens the fixture
    as the format the port's dispatch picks; where it raises (the TGA with
    a 10-byte image ID, which PCX's plugin takes), the port raises too."""
    Image.init()
    assert sorted(FRESH_ORDER) == sorted(Image.ID)
    data = path.read_bytes()
    try:
        with Image.open(path, formats=FRESH_ORDER) as im:
            fmt = im.format
    except sfx.PILLOW_ERRORS:                # Image.open refuses the file
        fmt = None
    if fmt is None:
        with pytest.raises(ValueError, match=path.name):
            image_io.image_size(path)
        return
    got = sf.pillow_open(data, path.name)
    assert isinstance(got, sf.Pic) and got.kind == fmt, path.name


def _unread():
    """(name, bytes, what the message says) of formats Pillow opens that
    the port does not read, three of which test no magic."""
    img = Image.fromarray(sfx.flat(6, 10, 3)[..., 0])
    return [("im.im", sfx._pillow(img, "IM"), "an IM file"),
            ("spider.spi", sfx._pillow(img.convert("F"), "SPIDER"),
             "a SPIDER file"),
            ("imt.imt", b"width 10\nheight 6\npixel n8\n\x0c" + bytes(60),
             "an IMT file"),
            ("ico.ico", sfx._pillow(img.resize((16, 16)), "ICO",
                                    sizes=[(16, 16)]), "an ICO file"),
            ("iptc.iptc", _iptc_file(), "an IPTC/NAA file")]


def _iptc_file() -> bytes:
    """An IPTC/NAA image: layers, size and compression fields, then the
    (8, 10) field its pixels follow."""
    def field(rec, tag, value):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(value)) + value

    return (field(3, 60, b"\x01\x00") + field(3, 20, struct.pack(">I", 4))
            + field(3, 30, struct.pack(">I", 2))
            + field(3, 120, struct.pack(">I", 1)) + b"\x1c\x08\x0a\x00\x08"
            + bytes(8))


@pytest.mark.parametrize("name,data,what", _unread(),
                         ids=[u[0] for u in _unread()])
def test_unread_formats_are_refused_by_name(name, data, what, tmp_path):
    """IM, IMT, SPIDER and IPTC (which test no magic, so the port repeats
    their header checks) and ICO open in Pillow; the port raises
    ``ValueError`` naming the file and the format, for both readers and
    the size."""
    p = tmp_path / name
    p.write_bytes(data)
    with Image.open(p, formats=FRESH_ORDER) as im:
        assert what.split()[1].split("/")[0] == im.format
    for fn in (image_io.read_rgb, image_io.read_raw, image_io.image_size,
               lambda q: image_io.read_rgb(q, reader="opencv")):
        with pytest.raises(ValueError, match=name) as e:
            fn(p)
        assert what in str(e.value)


def test_a_tga_with_a_10_byte_id_raises_as_pillow_does():
    """Pillow's PCX plugin takes a TGA whose image ID is 10 bytes long (its
    first bytes 10, 0) and makes ``Image.open`` raise; the port raises
    naming the file and PCX, for both readers."""
    p = ROOT / "coverage" / "tga_image_id10.tga"
    with pytest.raises(OSError, match="PCX"):
        Image.open(p)
    for reader in ("pillow", "opencv"):
        with pytest.raises(ValueError, match="tga_image_id10.tga.*PCX"):
            image_io.read_rgb(p, reader=reader)


def _loop_cases(path) -> list:
    """(the helper's loop, its reference, their arguments) for each loop
    that reads the coverage file at ``path``."""
    data = path.read_bytes()
    name = path.name
    cases = []
    if name.startswith("sun_") and data[23] == 2:
        w, h, depth = struct.unpack_from(">3I", data, 4)
        plen = struct.unpack_from(">I", data, 28)[0]
        cases.append((sf.sun_rle, sf.sun_rle_numpy,
                      (data[32 + plen:], (w * depth + 7) // 8 * h)))
    if name.startswith("tga_") and data[2] & 8:
        w, h = struct.unpack_from("<HH", data, 12)
        k = data[7] // 8 if data[1] else 0
        start = 18 + data[0] + k * struct.unpack_from("<H", data, 5)[0]
        row = (w * data[16] + 7) // 8
        cases.append((sf.tga_rle, sf.tga_rle_numpy,
                      (data[start:], data[16] // 8, row, row * h)))
    if name.startswith("sgi_") and data[2] == 1:
        _, w, h, z = struct.unpack_from(">4H", data, 4)
        cases.append((sf.sgi_rle, sf.sgi_rle_numpy,
                      (data[512:], w, h, z, data[3])))
    if name.startswith(("pcx_", "dcx_")):
        at = struct.unpack_from("<I", data, 4)[0] if name.startswith(
            "dcx") else 0
        x0, y0, x1, y1 = struct.unpack_from("<4H", data, at + 4)
        w, bits, planes = x1 + 1 - x0, data[at + 3], data[at + 65]
        stride = (w * bits + 7) // 8
        if struct.unpack_from("<H", data, at + 66)[0] != stride:
            stride += stride % 2
        cases.append((sf.pcx_rle, sf.pcx_rle_numpy,
                      (data[at + 128:], planes * stride, y1 + 1 - y0)))
    if name.startswith("qoi_"):
        w, h = struct.unpack_from(">II", data, 4)
        cases.append((sf.qoi, sf.qoi_numpy,
                      (data[14:], w * h, 3 if data[12] == 3 else 4)))
    if name.startswith("hdr_"):
        head = sf._hdr_header(data)
        cases.append((sf.hdr, sf.hdr_numpy, (data[head[2]:], *head[:2])))
    if data[:2] in (b"P1", b"P2", b"P3"):
        body = data[2:]
        for count in (1, 50, 10 ** 6):
            for bitonal in (data[1] == 49, False):
                cases.append((sf.pnm_pillow, sf.pnm_pillow_numpy,
                              (body, count, 65535, bitonal)))
            cases.append((sf.pnm_opencv, sf.pnm_opencv_numpy,
                          (body, count, int(data[1] == 49))))
    return cases


@pytest.mark.parametrize("path", [p for p in COVERAGE if _loop_cases(p)],
                         ids=lambda p: p.name)
def test_loops_equal_their_references(path):
    """Each run-length and op loop of the C++ helper equals its reference
    on the coverage file that runs it (the ASCII tokenisers on every
    ASCII Netpbm file)."""
    assert image_io.host_build.load("simple_decode")
    name = path.name
    for fast, ref, args in _loop_cases(path):
        a, b = fast(*args), ref(*args)
        assert a[0] == b[0], (name, fast.__name__)
        if a[0]:                           # a refusal: the status is all
            continue
        np.testing.assert_array_equal(np.asarray(
            np.frombuffer(a[1], np.uint8) if isinstance(a[1], bytes)
            else a[1]), np.asarray(np.frombuffer(b[1], np.uint8)
                                   if isinstance(b[1], bytes) else b[1]),
            err_msg=f"{name} {fast.__name__}")


def test_pam_rows_opencv_leaves_unset():
    """OpenCV fills the first ceil(width / depth) pixels of each row of a
    2- or 4-channel PAM and leaves the rest unset; the port's eval reader
    gives those the JAX eval's bits and 0 past them."""
    g = np.random.default_rng(4)
    for depth, tupl in ((2, "GRAYSCALE_ALPHA"), (4, "RGB_ALPHA")):
        data = sfx.pam(9, 5, depth, 255, g.integers(0, 256, (5, 9, depth)),
                       tupl)
        n = sf.pam_unset(data)
        assert n == -(-9 // depth)
        got = sf.opencv_read(data, "p.pam")
        want = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)[..., ::-1]
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
        assert not got[:, n:].any()


@settings(max_examples=14, deadline=None, database=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64),
       kind=st.sampled_from(["PPM", "PGM", "PBM", "TGA", "TGA_RLE", "SGI",
                             "PCX", "PCX_P", "QOI", "QOIA"]),
       seed=st.integers(0, 2 ** 16))
def test_sweep_matches_pillow(h, w, kind, seed, tmp_path_factory):
    """Random sizes and Pillow's writers (PPM, TGA raw and RLE, SGI, PCX,
    QOI): the port (C++ helper) equal to Pillow and to the JAX eval's
    reader, and raising where Pillow refuses the file it wrote (a PCX one
    pixel wide, at times)."""
    img = sfx.flat(h, w, seed) if seed % 2 else rf.scene(h, w, seed)
    im = Image.fromarray(img)
    if kind == "PGM":
        im = im.convert("L")
    elif kind == "PBM":
        im = im.convert("1")
    elif kind == "PCX_P":
        im = im.quantize(20)
    elif kind == "QOIA":
        im = Image.fromarray(np.dstack([img, img[..., :1]]))
    fmt = {"PGM": "PPM", "PBM": "PPM", "TGA_RLE": "TGA", "PCX_P": "PCX",
           "QOIA": "QOI"}.get(kind, kind)
    p = tmp_path_factory.mktemp("sweep") / "s.bin"
    p.write_bytes(sfx._pillow(im, fmt, **({"rle": True} if kind == "TGA_RLE"
                                          else {})))
    want = _library_reads(p)               # Pillow may refuse its own file
    got = {"rgb": _attempt(lambda: image_io.read_rgb(p)),
           "raw": _attempt(lambda: image_io.read_raw(p)),
           "size": _attempt(lambda: image_io.image_size(p)),
           "cv": _attempt(lambda: image_io.read_rgb(p, reader="opencv"))}
    _assert_reads_equal(got, want, kind)


def _broken():
    """(name, bytes, the kind the message names) of a truncated and a
    corrupt file of each format; Pillow (and OpenCV, where it reads the
    format) refuses each one."""
    cov = {p.name: p.read_bytes() for p in COVERAGE}
    sgi_rle = bytearray(cov["sgi_rgb_rle.sgi"])
    sgi_rle[512:516] = struct.pack(">I", 10 ** 6)    # a row past the end
    pcx_run = bytearray(cov["pcx_l.pcx"])
    pcx_run[128:130] = b"\xff\x07"                   # 63 bytes: past the row
    qoi_hdr = cov["qoi_rgb.qoi"]
    hdr_bad = bytearray(cov["hdr_rle.hdr"])
    i = hdr_bad.index(b"\x02\x02\x00\x0d")
    hdr_bad[i + 3] = 12                              # the wrong width
    tga_bad = bytearray(cov["tga_rgb.tga"])
    tga_bad[16] = 15
    grey = cov["tga_l.tga"]                        # 14 x 11, 8 bits
    tga_run = grey[:2] + b"\x0b" + grey[3:18] + b"\x8f\x07" * 11
    return [
        ("short.ppm", cov["p6.ppm"][:-10], "PPM"),
        ("short_plain.pgm", cov["p2_ascii_maxval100.pgm"][:-40], "PPM"),
        ("bad_token.pgm", cov["p2_ascii_maxval100.pgm"].replace(
            b"100\n", b"100\nx ", 1), "PPM"),
        ("big_value.pgm", b"P2\n2 1\n100\n7 101\n", "PPM"),
        ("maxval0.pgm", b"P5\n2 1\n0\n\x00\x00", "PPM"),
        ("short.pfm", cov["pf_little.pfm"][:-4], "PFM"),
        ("short.pam", cov["pam_rgb16.pam"][:-4], "PAM"),
        ("bad_tupltype.pam", cov["pam_rgb16.pam"].replace(b"TUPLTYPE RGB",
                                                          b"TUPLTYPE XYZ"),
         "PAM"),
        ("short.ras", cov["sun_24_old.ras"][:-7], "Sun raster"),
        ("short_rle.ras", cov["sun_8_rle.ras"][:-5], "Sun raster"),
        ("short.tga", cov["tga_rgb.tga"][:-40], "TGA"),   # past its footer
        ("short_rle.tga", cov["tga_rgb_rle.tga"][:-40], "TGA"),
        ("bad_depth.tga", bytes(tga_bad), "TGA"),
        ("run_across_rows.tga", tga_run, "TGA"),
        ("short.sgi", cov["sgi_rgb.sgi"][:-9], "SGI"),
        ("bad_table.sgi", bytes(sgi_rle), "SGI"),
        ("short.pcx", cov["pcx_rgb.pcx"][:-20], "PCX"),
        ("long_run.pcx", bytes(pcx_run), "PCX"),
        ("short.qoi", qoi_hdr[:-60], "QOI"),
        ("short.xbm", cov["xbm.xbm"][:-30], "XBM"),
        ("short.hdr", cov["hdr_rle.hdr"][:-9], "Radiance HDR"),
        ("bad_width.hdr", bytes(hdr_bad), "Radiance HDR"),
        ("short.dcx", cov["dcx_two_pages.dcx"][:200], "DCX")]


@pytest.mark.parametrize("name,data,what", _broken(),
                         ids=[b[0] for b in _broken()])
def test_broken_file_raises_naming_the_file(name, data, what, tmp_path,
                                            helpers):
    """A truncated or corrupt file raises ValueError naming the file and
    its kind, with the helper and with the references, where Pillow
    raises; the eval reader raises too where OpenCV reads nothing, and
    gives OpenCV's bits where it reads the file (an ASCII value past its
    maxval, which OpenCV clips)."""
    p = tmp_path / name
    p.write_bytes(data)
    with pytest.raises((OSError, ValueError, SyntaxError, IndexError)):
        with Image.open(p) as im:
            im.convert("RGB")
    cv = cv2.imread(str(p), FLAGS)
    readers = ("pillow",) if cv is not None else ("pillow", "opencv")
    for reader in readers:
        with pytest.raises(ValueError, match=name) as e:
            image_io.read_rgb(p, reader=reader)
        assert what in str(e.value), str(e.value)
    if cv is not None:
        np.testing.assert_array_equal(image_io.read_rgb(p, reader="opencv"),
                                      cv[..., ::-1])


def _library_reads(p) -> dict:
    """What the JAX package's readers give for the file at ``p``: Pillow's
    ``convert("RGB")``, ``np.asarray(Image.open())`` and size, and the
    eval's frame (OpenCV's, else Pillow's), each None where it raises."""
    got = dict.fromkeys(("rgb", "raw", "size", "cv"))
    try:
        with Image.open(p) as im:
            got["size"] = im.size
            got["raw"] = np.asarray(im)
            got["rgb"] = np.asarray(im.convert("RGB"))
    except sfx.PILLOW_ERRORS + (Image.DecompressionBombError,):
        got["raw"] = got["rgb"] = None
    try:
        cv = cv2.imread(str(p), FLAGS)
        got["cv"] = got["rgb"] if cv is None else cv[..., ::-1]
    except cv2.error:                      # imread raises: the eval stops
        pass
    return got


def _assert_reads_equal(got: dict, want: dict, what):
    """The port's reads equal the libraries' bytes, dtype and shape, and
    are None (``ValueError``) exactly where the libraries raise."""
    for k, v in want.items():
        assert (got[k] is None) == (v is None), (what, k)
        if k == "size" or v is None:
            assert got[k] == v, (what, k)
        else:
            assert (got[k].dtype, got[k].shape, got[k].tobytes()) == (
                v.dtype, v.shape, v.tobytes()), (what, k)


@pytest.mark.parametrize("seed", range(3))
def test_mutated_files_read_as_the_libraries_do(seed, tmp_path):
    """Each coverage file cut short, with a header byte changed or with a
    body byte changed (seeded): the port's four reads equal the
    libraries' bytes, or raise ``ValueError`` where they raise."""
    g = np.random.default_rng(seed)
    for path in COVERAGE:
        d = bytearray(path.read_bytes())
        kind = g.integers(0, 3)
        if kind == 0:
            d = d[:g.integers(1, len(d))]
        else:
            d[g.integers(0, min(len(d), 40) if kind == 1 else len(d))] = \
                g.integers(0, 256)
        p = tmp_path / path.name
        p.write_bytes(bytes(d))
        want = _library_reads(p)
        got = {"rgb": _attempt(lambda: image_io.read_rgb(p)),
               "raw": _attempt(lambda: image_io.read_raw(p)),
               "size": _attempt(lambda: image_io.image_size(p)),
               "cv": _attempt(lambda: image_io.read_rgb(p,
                                                        reader="opencv"))}
        _assert_reads_equal(got, want, (path.name, kind))


def _header_combinations(g) -> list:
    """(name, bytes) of Sun, TGA, SGI, PCX and PAM files over the products
    of their header fields (depth, type, colour map, orientation, channels,
    version, planes, maxval, tuple type), the pixels random."""
    out = []
    for depth, ftype, mtype, mlen in itertools.product(
            (1, 4, 8, 24, 32), (0, 1, 2, 3), (0, 1, 2), (0, 6, 800)):
        row, stride = (7 * depth + 7) // 8, (7 * depth + 15) // 16 * 2
        body = g.integers(0, 256, stride * 5, dtype=np.uint8).tobytes()
        if ftype == 2:
            body = sfx.sun_rle(body[:row * 5])
        out.append((f"sun_{depth}_{ftype}_{mtype}_{mlen}.ras",
                    struct.pack(">8I", 0x59A66A95, 7, 5, depth, len(body),
                                ftype, mtype, mlen)
                    + g.integers(0, 256, mlen, dtype=np.uint8).tobytes()
                    + body))
    for itype, depth, (cmt, md), orient in itertools.product(
            (1, 2, 3, 9, 10, 11), (1, 8, 16, 24, 32),
            ((0, 0), (1, 16), (1, 24), (1, 32)), (0x00, 0x30)):
        row = (6 * depth + 7) // 8
        px = g.integers(0, 8, row * 4, dtype=np.uint8).tobytes()
        body = sfx.tga_rle(px, depth // 8, 6) if itype & 8 and depth >= 8 \
            else px
        out.append((f"tga_{itype}_{depth}_{cmt}_{md}_{orient}.tga",
                    sfx.tga(6, 4, itype, depth, body, orient=orient,
                            cmap=bytes(md) if cmt else b"",
                            map_len=8 if cmt else 0, map_depth=md)))
    for bpc, dim, z, comp in itertools.product((1, 2), (1, 2, 3),
                                               (1, 2, 3, 4), (0, 1, 2)):
        d = bytearray(sfx.sgi(g.integers(0, 256 ** bpc, (4, 6, z)), bpc=bpc,
                              rle=comp == 1, dimension=dim))
        d[2] = comp
        out.append((f"sgi_{bpc}_{dim}_{z}_{comp}.sgi", bytes(d)))
    for ver, bits, planes, pad in itertools.product((2, 5), (1, 2, 8),
                                                    (1, 2, 3, 4), (0, 1)):
        st = (9 * bits + 7) // 8 + pad
        head = struct.pack("<BBBBHHHHHH", 10, ver, 1, bits, 0, 0, 8, 2, 72,
                           72) + bytes(48)
        head += struct.pack("<BBHH", 0, planes, st, 1).ljust(64, b"\0")
        rows = g.integers(0, 4, (3, planes * st), dtype=np.uint8)
        out.append((f"pcx_{ver}_{bits}_{planes}_{pad}.pcx", head
                    + sfx.pcx_rle(rows) + b"\x0c" + bytes(range(256)) * 3))
    for depth, maxval, tupl in itertools.product(
            (1, 2, 3, 4), (1, 100, 255, 1000),
            (None, "RGB", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB_ALPHA")):
        w = 1 if depth in (2, 4) else 5
        out.append((f"pam_{depth}_{maxval}_{tupl}.pam", sfx.pam(
            w, 3, depth, maxval, g.integers(0, maxval + 1, (3, w, depth)),
            tupl)))
    return out


def test_header_combinations_read_as_the_libraries_do(tmp_path):
    """Files over the products of each format's header fields read as
    the libraries read them, or raise where they raise: among them a grey
    TGA with a colour map (Pillow makes it "P"), a Sun map past 256
    entries (Pillow refuses it), a PAM whose TUPLTYPE's channels are not
    its DEPTH (OpenCV refuses it)."""
    for name, data in _header_combinations(np.random.default_rng(7)):
        p = tmp_path / name
        p.write_bytes(data)
        got = {"rgb": _attempt(lambda: image_io.read_rgb(p)),
               "raw": _attempt(lambda: image_io.read_raw(p)),
               "size": _attempt(lambda: image_io.image_size(p)),
               "cv": _attempt(lambda: image_io.read_rgb(p,
                                                        reader="opencv"))}
        _assert_reads_equal(got, _library_reads(p), name)


def test_clip_loader_on_mixed_video_matches_jax():
    """The mixed-format video through both packages' index, dataset and
    loader (JAX: Pillow; port: its reader), frames at 64 px and every
    field of every batch equal."""
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
    fixture either reads as a one-frame clip, and on an 8-frame clip of
    the mixed-format video; where the JAX reader raises, the port's
    raises ``ValueError``."""
    assert sys.modules[JRunner.__module__]._cv2 is not None
    runner = types.SimpleNamespace(image_root=None)
    files = COVERAGE + sorted((ROOT / "timing").iterdir())
    assert len(files) == 109
    for p in files:
        clip = [{"file_name": p.name, "path": str(p)}]
        try:
            want = JRunner._load_frames(runner, clip)
        except sfx.PILLOW_ERRORS:
            with pytest.raises(ValueError, match=p.name):
                TRunner._load_frames(runner, clip)
            continue
        got = TRunner._load_frames(runner, clip)
        assert got.dtype == want.dtype == np.uint8, p.name
        np.testing.assert_array_equal(got, want, err_msg=p.name)
    frames = json.loads((VIDEO / "annotations.json").read_text())["images"]
    runner = types.SimpleNamespace(image_root=str(VIDEO / "images"))
    want = JRunner._load_frames(runner, frames[8:16])
    got = TRunner._load_frames(runner, frames[8:16])
    assert got.shape == (8, 240, 320, 3)
    np.testing.assert_array_equal(got, want)
