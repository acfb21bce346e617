"""ctypes bindings of the C++ COCO RLE codec (``native/rle.cpp``), built by
``host_build`` on first use. ``load`` returns the library, or None when it
cannot be built; ``rle.py`` then uses its numpy codec."""

from __future__ import annotations

import ctypes

import numpy as np

from . import host_build

_lib = None


def load():
    """The bound library, built on the first call, or None."""
    global _lib
    if _lib is None:
        lib = host_build.load("rle")
        if lib is not None:
            i64 = ctypes.c_int64
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.rle_decode_counts.restype = i64
            lib.rle_decode_counts.argtypes = [ctypes.c_char_p, i64, p_i64,
                                              i64]
            lib.rle_fill.restype = i64
            lib.rle_fill.argtypes = [p_i64, i64, p_u8, i64]
            lib.rle_from_mask.restype = i64
            lib.rle_from_mask.argtypes = [p_u8, i64, p_i64, i64]
            lib.rle_encode_counts.restype = i64
            lib.rle_encode_counts.argtypes = [p_i64, i64, ctypes.c_char_p,
                                              i64]
        _lib = lib or False
    return _lib or None


def decode_counts_native(s: str) -> np.ndarray:
    b = s.encode("ascii")
    out = np.empty(len(b) + 1, dtype=np.int64)
    n = _lib.rle_decode_counts(b, len(b), out, out.size)
    if n < 0:
        raise ValueError("RLE counts overflow")
    return out[:n]


def encode_counts_native(counts: np.ndarray) -> str:
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    buf = ctypes.create_string_buffer(int(counts.size) * 16 + 16)
    n = _lib.rle_encode_counts(counts, counts.size, buf, len(buf))
    if n < 0:
        raise ValueError("RLE encode overflow")
    return buf.raw[:n].decode("ascii")


def fill_native(counts: np.ndarray, total: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    mask = np.empty(total, dtype=np.uint8)
    if _lib.rle_fill(counts, counts.size, mask, total) != 0:
        raise ValueError("RLE counts do not match mask size")
    return mask


def counts_from_mask_native(flat_mask: np.ndarray) -> np.ndarray:
    flat_mask = np.ascontiguousarray(flat_mask, dtype=np.uint8)
    out = np.empty(flat_mask.size + 2, dtype=np.int64)
    n = _lib.rle_from_mask(flat_mask, flat_mask.size, out, out.size)
    if n < 0:
        raise ValueError("RLE from-mask overflow")
    return out[:n]
