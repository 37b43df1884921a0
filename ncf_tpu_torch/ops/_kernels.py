"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, bound with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``ncf_tpu_torch/ops/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and flags, so an edited source rebuilds and
an unchanged one is reused.  Nothing is built at import time: the first
call that needs a kernel builds it, and ``build_all`` builds every source
at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("topk_streaming",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    src, lib = _target(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, cmd


def _finish_build(job) -> None:
    proc, tmp, lib, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)      # atomic: a concurrent build never sees half a file


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every named source in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [j for j in (_start_build(n) for n in names) if j is not None]
        try:
            for job in jobs:
                _finish_build(job)
        finally:
            for proc, *_ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_target(name)[1])
        return _libs[name]


def topk_streaming_lib() -> ctypes.CDLL:
    """``ncf_topk_streaming`` with its argument types declared."""
    lib = library("topk_streaming")
    fn = lib.ncf_topk_streaming
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, I, I, I, I, P, P, P, P]
        fn.restype = ctypes.c_int
        lib.ncf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ncf_cuda_error_string.restype = ctypes.c_char_p
    return lib
