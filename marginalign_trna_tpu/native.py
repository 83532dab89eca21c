"""ctypes bindings for the native host-runtime library (native/).

Auto-builds native/libmargin_native.so on first use when a toolchain is
available; every entry point has a pure-Python fallback so the framework
works without the native layer (just slower host-side chaining/packing).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmargin_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MARGINALIGN_NO_NATIVE"):
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.chain_seeds.restype = i64
    lib.chain_seeds.argtypes = [
        p(i64), p(i64), i64, i64, i64, p(i64), i64,
    ]
    lib.pack_band_batch.restype = None
    lib.pack_band_batch.argtypes = [
        p(ctypes.c_int8), p(i64), p(ctypes.c_int32),
        p(ctypes.c_int8), p(i64), p(ctypes.c_int32),
        p(ctypes.c_int32), i64,
        i64, i64, i64, i64,
        p(ctypes.c_int8), p(ctypes.c_int8), p(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def pack_band_batch(
    reads, refs, lo: np.ndarray, width: int,
    xb: np.ndarray, yb: np.ndarray, valid: np.ndarray,
) -> bool:
    """Fill lanes 0..len(reads)-1 of the zeroed [D1, Wp, B] banded arrays
    from encoded reads/refs and the [D1, B] band offsets lo.  Returns False
    when the native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    d1, wp, b = xb.shape
    if not (xb.flags.c_contiguous and yb.flags.c_contiguous
            and valid.flags.c_contiguous and valid.dtype == np.bool_
            and xb.dtype == yb.dtype == np.int8
            and yb.shape == valid.shape == xb.shape
            and lo.shape == (d1, b) and len(reads) == len(refs) <= b):
        raise ValueError("pack_band_batch: inconsistent batch arrays")
    m = np.array([len(r) for r in reads], np.int32)
    n = np.array([len(r) for r in refs], np.int32)
    read_off = np.concatenate([[0], np.cumsum(m, dtype=np.int64)[:-1]])
    ref_off = np.concatenate([[0], np.cumsum(n, dtype=np.int64)[:-1]])
    cat_reads = np.ascontiguousarray(
        np.concatenate(list(reads) + [np.zeros(1, np.int8)]), dtype=np.int8)
    cat_refs = np.ascontiguousarray(
        np.concatenate(list(refs) + [np.zeros(1, np.int8)]), dtype=np.int8)
    lo32 = np.ascontiguousarray(lo, dtype=np.int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pack_band_batch(
        cat_reads.ctypes.data_as(i8p), read_off.ctypes.data_as(i64p),
        m.ctypes.data_as(i32p),
        cat_refs.ctypes.data_as(i8p), ref_off.ctypes.data_as(i64p),
        n.ctypes.data_as(i32p),
        lo32.ctypes.data_as(i32p), width, d1, wp, b, len(reads),
        xb.ctypes.data_as(i8p), yb.ctypes.data_as(i8p),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return True


def chain_seeds(
    q: np.ndarray, r: np.ndarray, max_gap2: int, max_drift: int
) -> Optional[np.ndarray]:
    """Indices (chain order) of the best colinear chain, or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    out = np.empty(len(q), dtype=np.int64)
    cnt = lib.chain_seeds(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(q), max_gap2, max_drift,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(out),
    )
    if cnt < 0:
        return None
    return out[:cnt]
