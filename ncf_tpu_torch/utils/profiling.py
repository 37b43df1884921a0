"""Profiling: device trace capture, the program's spans and counters.

Port of ``ncf_tpu/utils/profiling.py`` on ``torch.profiler``, the
counterpart of the reference's wall-clock instrumentation (reference:
src/model/trainer.py:257-259, 274-286 forward/backward timing; :304-324
tqdm postfix + periodic stat logs; config mentions Vertex TensorBoard,
config.yaml:43-45, but never writes to it).  ``trace`` captures a
``torch.profiler`` trace of the host and, on a card, of every CUDA kernel
(the port's hand-written kernels too: they run on PyTorch's stream).

The program marks its phases with ``annotate`` (the serving call's
``serve.*`` spans, the training step's ``step.*``, ``pipeline.epoch``)
and keeps ``RecordedCount``s (the sparse update's rows).  Both exist
exactly while a profiler records (``recording()``): there is no flag.
With no profiler a span is one check and a shared no-op context, and a
count adds nothing.  On the profiler's timeline each device operation
falls to the span whose host interval launched it.

Timing note: CUDA launches are asynchronous, so a host clock read after
a launch says when the launch returned, not when the kernel ended: time
a chain of calls and wait for the card once at its end.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Union

import torch
from torch.autograd import profiler as _autograd_profiler

from ncf_tpu_torch.utils.device import DeviceLike, resolve_device


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of every tensor in a tensor or nested dicts,
    lists and tuples of them."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def block_until_ready(tree) -> None:
    """Wait for the work queued on the card of every CUDA tensor in
    ``tree``; CPU tensors need no wait (and CUDA is left uninitialised)."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (the TensorBoard integration the reference configured but never
    wired, config.yaml:43-45).  On exit it writes a Chrome trace,
    ``<worker>.<id>.pt.trace.json``, which TensorBoard's PyTorch profiler
    plugin and ``chrome://tracing`` open.  ``device`` (default ``cuda``;
    raises without a card unless ``"cpu"``) picks the activities: the
    host's, plus the card's kernels on a CUDA device."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield log_dir
        finally:
            if dev.type == "cuda":   # the block's kernels end inside the trace
                torch.cuda.synchronize(dev)


def recording() -> bool:
    """Whether a profiler records: torch's own flag for fast checks, set
    while any ``torch.profiler``/``torch.autograd.profiler`` profile runs
    (a plain read, where ``torch.autograd._profiler_enabled()`` is a call
    into C++)."""
    return _autograd_profiler._is_profiler_enabled


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` on the profiler's timeline while a profiler
    records, else one shared no-op context.

    The span is a host event of function scope (``_RecordFunctionFast``),
    as an ATen op is.  ``torch.profiler.record_function`` opens a user
    scope instead, for which the CUDA profiler also writes a device-side
    copy of the span over the kernels it launched: a traced slice would
    count those as device operations and as busy time."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


class RecordedCount:
    """A count the program keeps while a profiler records: ``add`` takes
    an int, or a function that gives one when the count is read (it may
    hold one-element views of device tensors the program made anyway, so
    counting launches nothing and never waits for the card; a view keeps
    its tensor's memory until then).  Reading ``value`` evaluates those,
    waiting for the card."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._later: List[Callable[[], int]] = []

    def add(self, n: Union[int, Callable[[], int]]) -> None:
        with self._lock:
            if callable(n):
                self._later.append(n)
            else:
                self._n += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            self._n += sum(int(f()) for f in self._later)
            self._later.clear()
            return self._n
