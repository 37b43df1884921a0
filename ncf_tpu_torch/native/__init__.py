"""ctypes bindings for the port's copy of the native data-loader library.

The port's counterpart of ``ncf_tpu/native/__init__.py``: the same C++
source (``data_loader.cpp``, copied), built with the flags of
``ncf_tpu/native/Makefile`` into ``ncf_tpu_torch/native/_build/``
(git-ignored) at first use, never at import.  Every entry point has the
same NumPy fallback as the JAX package's, so where both packages find a
compiler (or neither does) they shuffle and sample identically.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "data_loader.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_SO = os.path.join(BUILD_DIR, "libncf_native.so")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", tmp,
           _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.info("native build unavailable: %s", e)
        return False
    os.replace(tmp, _SO)        # atomic: a concurrent loader never sees half
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (NumPy fallbacks will be used)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and not _build():
            return None
        lib = ctypes.CDLL(_SO)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.ncf_build_histories.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p]
        lib.ncf_build_histories.restype = None
        lib.ncf_sample_negatives.argtypes = [
            i32p, i32p, ctypes.c_int64, f64p, ctypes.c_int32, ctypes.c_int32,
            i64p, i32p, ctypes.c_uint64, ctypes.c_int32, i32p]
        lib.ncf_sample_negatives.restype = None
        lib.ncf_shuffled_indices.argtypes = [ctypes.c_int64, ctypes.c_uint64,
                                             i64p]
        lib.ncf_shuffled_indices.restype = None
        _lib = lib
        log.info("native data loader loaded: %s", _SO)
        return _lib


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------ API

def build_histories(user_ids: np.ndarray, item_ids: np.ndarray,
                    num_users: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user CSR (offsets int64[U+1], items int32[n] sorted per user)."""
    user_ids = np.ascontiguousarray(user_ids, np.int32)
    item_ids = np.ascontiguousarray(item_ids, np.int32)
    n = len(user_ids)
    lib = get_lib()
    offsets = np.zeros(num_users + 1, np.int64)
    items = np.zeros(n, np.int32)
    if lib is not None:
        lib.ncf_build_histories(user_ids, item_ids, n, num_users,
                                offsets, items)
        return offsets, items
    order = np.lexsort((item_ids, user_ids))
    counts = np.bincount(user_ids, minlength=num_users)
    np.cumsum(counts, out=offsets[1:])
    return offsets, item_ids[order].astype(np.int32)


def sample_negatives_exact(
    users: np.ndarray, pos_items: np.ndarray, weights: np.ndarray,
    hist_offsets: np.ndarray, hist_items: np.ndarray,
    num_negatives: int, seed: int = 0, max_rounds: int = 16,
) -> np.ndarray:
    """Weighted negatives with exact full-history exclusion."""
    users = np.ascontiguousarray(users, np.int32)
    pos_items = np.ascontiguousarray(pos_items, np.int32)
    weights = np.ascontiguousarray(weights, np.float64)
    hist_offsets = np.ascontiguousarray(hist_offsets, np.int64)
    hist_items = np.ascontiguousarray(hist_items, np.int32)
    n = len(users)
    num_items = len(weights)
    out = np.zeros(n * num_negatives, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.ncf_sample_negatives(
            users, pos_items, n, weights, num_items, num_negatives,
            hist_offsets, hist_items, seed, max_rounds, out)
        return out.reshape(n, num_negatives)
    rng = np.random.default_rng(seed)
    p = weights / weights.sum()
    res = out.reshape(n, num_negatives)
    for i in range(n):
        lo, hi = hist_offsets[users[i]], hist_offsets[users[i] + 1]
        hist = hist_items[lo:hi]
        for j in range(num_negatives):
            cand = -1
            for _ in range(max_rounds):
                c = rng.choice(num_items, p=p)
                pos_found = hist[np.searchsorted(hist, c):][:1]
                if c != pos_items[i] and not (
                        len(pos_found) and pos_found[0] == c):
                    cand = int(c)
                    break
            if cand < 0:
                allowed = np.setdiff1d(np.arange(num_items),
                                       np.append(hist, pos_items[i]))
                cand = int(rng.choice(allowed)) if len(allowed) else (
                    int(pos_items[i] + 1) % num_items)
            res[i, j] = cand
    return res


def shuffled_indices(n: int, seed: int = 0) -> np.ndarray:
    lib = get_lib()
    out = np.zeros(n, np.int64)
    if lib is not None:
        lib.ncf_shuffled_indices(n, seed, out)
        return out
    return np.random.default_rng(seed).permutation(n)
