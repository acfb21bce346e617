"""Builds the data pipeline's host C++ helpers with g++ and loads them with
ctypes: the COCO RLE codec (``native/rle.cpp`` at the repository root),
the PNG row unfilter (``csrc/png_unfilter.cpp``), the JPEG decoder
(``csrc/jpeg_decode.cpp``), the TIFF, BMP and GIF codecs' loops
(``csrc/raster_decode.cpp``), the WebP decoder's
(``csrc/webp_decode.cpp``) and the simple formats' run-length, QOI, HDR and
ASCII Netpbm loops (``csrc/simple_decode.cpp``).

Each library lands in the package's ``build/`` directory, written under a
temporary name and renamed into place, so processes that build at the same
time (test workers) never load a half-written file. A library is rebuilt
when its source is newer. ``load`` returns None when the source or g++ is
missing or the build fails: the callers then use their numpy versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD = PKG / "build"
SOURCES = {"rle": PKG.parent / "native" / "rle.cpp",
           "png_unfilter": PKG / "csrc" / "png_unfilter.cpp",
           "jpeg_decode": PKG / "csrc" / "jpeg_decode.cpp",
           "raster_decode": PKG / "csrc" / "raster_decode.cpp",
           "webp_decode": PKG / "csrc" / "webp_decode.cpp",
           "simple_decode": PKG / "csrc" / "simple_decode.cpp"}
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}_host.so"


def build(name: str, force: bool = False) -> bool:
    """Compile ``SOURCES[name]`` when its library is missing or stale (or
    always, with ``force``); False when it cannot be built."""
    src, lib = SOURCES[name], lib_path(name)
    if not src.exists():
        return False
    if (not force and lib.exists()
            and lib.stat().st_mtime >= src.stat().st_mtime):
        return True
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}_host.{os.getpid()}.tmp.so"
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def load(name: str) -> ctypes.CDLL | None:
    """The library of ``name``, built first when needed, or None."""
    with _lock:
        if name not in _libs:
            lib = None
            if build(name):
                try:
                    lib = ctypes.CDLL(str(lib_path(name)))
                except OSError:
                    lib = None
            _libs[name] = lib
        return _libs[name]
