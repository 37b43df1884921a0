"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, bound with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``ncf_tpu_torch/ops/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built at import time: the first
call that needs a kernel builds it, and ``build_all`` builds every source
at once, one ``nvcc`` per source, all started together.  Several
processes may build at once (the ranks of a mesh): each writes its own
temporary file and renames it into place, and a lock file
(``file_lock``) makes the later processes wait and reuse the first one's
libraries instead of compiling them again.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Sequence, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("topk_streaming", "tree_sampler", "scatter_add", "temporal_sum",
           "fused_tower", "topk_streaming_int8", "topk_exact", "topk_segmax",
           "gather")

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
    """(source, library path); the name hashes the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


@contextlib.contextmanager
def file_lock(path: str):
    """An exclusive advisory lock on ``path`` across processes."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start_build(name: str):
    src, lib = _target(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
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
    with _lock, file_lock(os.path.join(BUILD_DIR, ".lock")):
        # under the lock: what another process built meanwhile is reused
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


# argument codes for ``bind``: a pointer (or the stream), an int, a 64-bit
# int, a float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


# (library, C function, signature) -> the bound function
_bound: Dict[Tuple[str, str, str], Callable[..., int]] = {}


def bind(name: str, fn_name: str, signature: str):
    """``fn_name`` of ``csrc/<name>.cu`` with its argument types declared
    from ``signature`` (one code of ``_CTYPES`` per argument), returning a
    CUDA error code.  Every library exports ``ncf_cuda_error_string``.
    Bound once a process: later calls read a dict, without a lock."""
    key = (name, fn_name, signature)
    fn = _bound.get(key)
    if fn is not None:
        return fn
    lib = library(name)
    with _lock:
        fn = getattr(lib, fn_name)
        lib.ncf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ncf_cuda_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in signature]
        _bound[key] = fn
    return fn


def launch(name: str, fn_name: str, signature: str, *args) -> None:
    """Call a kernel's C entry point; raise if the launch was refused."""
    if len(args) != len(signature):
        raise TypeError(f"{fn_name} takes {len(signature)} arguments, "
                        f"got {len(args)}")
    err = bind(name, fn_name, signature)(*args)
    if err != 0:
        msg = library(name).ncf_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def on_device(device):
    """``torch.cuda.device(device)`` where ``device`` is a card other than
    the current one, else a context that does nothing (a CPU device
    touches no CUDA).  Every wrapper enters its kernel's device so."""
    import torch

    idx = device.index
    if idx is None or idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def stream_of(t) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


class LaunchCounter:
    """Thread-safe count of kernel launches, one per launch of the
    kernel on the card (the CPU path adds nothing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
