"""Native (C++) host-side kernels with automatic build + NumPy fallback.

Host code, not a GPU kernel: the string edit-distance matrices that feed the
AddTypos tables at compile time, which the reference does lazily per pair in
Julia (add_typos.jl:47-66). The library is built with g++ at first use into
the port's build directory (pclean_tpu_torch/_build/, listed in .gitignore),
never into the package itself.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "_dl.so")
_SRC_PATH = os.path.join(_HERE, "dl.cpp")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _try_build() -> None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            if (not os.path.exists(_SO_PATH)) or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH):
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", _SRC_PATH, "-o", _SO_PATH + ".tmp"]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(_SO_PATH + ".tmp", _SO_PATH)
            lib = ctypes.CDLL(_SO_PATH)
            lib.osa_distance_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.subsequence_matrix.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        except Exception:
            _build_failed = True


def _as_i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def have_native() -> bool:
    _try_build()
    return _lib is not None


def osa_distance_matrix(a: np.ndarray, alen: np.ndarray, b: np.ndarray, blen: np.ndarray) -> np.ndarray:
    """Restricted Damerau-Levenshtein distances between padded char-code rows.

    a: int32 [na, L]; alen: int32 [na]; b: int32 [nb, L]; blen: int32 [nb].
    Returns int32 [na, nb].
    """
    _try_build()
    na, L = a.shape
    nb = b.shape[0]
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    alen = np.ascontiguousarray(alen, dtype=np.int32)
    blen = np.ascontiguousarray(blen, dtype=np.int32)
    if _lib is not None:
        out = np.empty((na, nb), dtype=np.int32)
        _lib.osa_distance_matrix(
            _as_i32_ptr(a), _as_i32_ptr(alen), na,
            _as_i32_ptr(b), _as_i32_ptr(blen), nb,
            L, _as_i32_ptr(out))
        return out
    return _osa_numpy(a, alen, b, blen)


def subsequence_matrix(a: np.ndarray, alen: np.ndarray, b: np.ndarray, blen: np.ndarray) -> np.ndarray:
    """out[i, j] = 1 iff a[i] is a subsequence of b[j]. Returns uint8 [na, nb]."""
    _try_build()
    na, L = a.shape
    nb = b.shape[0]
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    alen = np.ascontiguousarray(alen, dtype=np.int32)
    blen = np.ascontiguousarray(blen, dtype=np.int32)
    if _lib is not None:
        out = np.empty((na, nb), dtype=np.uint8)
        _lib.subsequence_matrix(
            _as_i32_ptr(a), _as_i32_ptr(alen), na,
            _as_i32_ptr(b), _as_i32_ptr(blen), nb,
            L, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    out = np.empty((na, nb), dtype=np.uint8)
    for i in range(na):
        s = a[i, : alen[i]]
        for j in range(nb):
            t = b[j, : blen[j]]
            p = 0
            for ch in t:
                if p < len(s) and s[p] == ch:
                    p += 1
            out[i, j] = 1 if p >= len(s) else 0
    return out


def _osa_numpy(a: np.ndarray, alen: np.ndarray, b: np.ndarray, blen: np.ndarray) -> np.ndarray:
    """Vectorized-over-pairs NumPy fallback for the OSA distance matrix.

    Rolls the DP over rows p; when p reaches a given a-string's length, that
    string's distances are read off the current DP row at each b-length.
    """
    na, L = a.shape
    nb = b.shape[0]
    La, Lb = int(alen.max(initial=0)), int(blen.max(initial=0))
    out = np.empty((na, nb), dtype=np.int32)
    cols = np.arange(nb)
    prev2 = np.zeros((na, nb, Lb + 1), dtype=np.int32)
    prev = np.broadcast_to(np.arange(Lb + 1, dtype=np.int32), (na, nb, Lb + 1)).copy()
    cur = np.empty_like(prev)
    bmat = b[None, :, :max(Lb, 1)]  # [1, nb, Lb]
    done0 = alen == 0
    if done0.any():
        out[done0] = blen[None, :]
    for p in range(1, La + 1):
        cur[:, :, 0] = p
        ca = a[:, p - 1][:, None]  # [na, 1]
        for q in range(1, Lb + 1):
            cb = bmat[:, :, q - 1]  # [1->na, nb]
            cost = (ca != cb).astype(np.int32)
            d = np.minimum(prev[:, :, q] + 1, cur[:, :, q - 1] + 1)
            d = np.minimum(d, prev[:, :, q - 1] + cost)
            if p > 1 and q > 1:
                trans = (ca == bmat[:, :, q - 2]) & (a[:, p - 2][:, None] == cb)
                d = np.where(trans, np.minimum(d, prev2[:, :, q - 2] + 1), d)
            cur[:, :, q] = d
        prev2, prev, cur = prev, cur, prev2
        at_len = alen == p
        if at_len.any():
            out[at_len] = prev[at_len][:, cols, blen]
    return out
