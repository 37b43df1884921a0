"""Profiling: step timing, throughput counters, device trace capture.

Port of ``ncf_tpu/utils/profiling.py`` on ``torch.profiler``, the
counterpart of the reference's wall-clock instrumentation (reference:
src/model/trainer.py:257-259, 274-286 forward/backward timing; :304-324
tqdm postfix + periodic stat logs; config mentions Vertex TensorBoard,
config.yaml:43-45, but never writes to it).  ``StepTimer`` times steps
including the device's work, ``trace`` captures a ``torch.profiler``
trace of the host and, on a card, of every CUDA kernel (the port's
hand-written kernels too: they run on PyTorch's stream), and ``annotate``
names a span of it.

Timing note: CUDA launches are asynchronous, so a host clock read after
a launch says when the launch returned, not when the kernel ended.
``StepTimer`` therefore times a chain of calls whose outputs feed the
next call's inputs (a train step does: the parameters chain through), so
the queue cannot run ahead by more than its depth, and ``stats(block_on=
...)`` waits for the card once before it reports.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

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


@dataclass
class StepTimer:
    """Rolling step-time/throughput tracker.

    Usage::
        timer = StepTimer(batch_size=8192)
        for batch in data:
            state = step(state, batch)
            timer.tick()                      # cheap; no device sync
        stats = timer.stats(block_on=state)   # syncs once, then reports
    """

    batch_size: int = 0
    window: int = 100
    _times: List[float] = field(default_factory=list)
    _t_last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._times.append(now - self._t_last)
            if len(self._times) > self.window:
                self._times = self._times[-self.window:]
        self._t_last = now

    def reset(self) -> None:
        self._times.clear()
        self._t_last = None

    def stats(self, block_on=None) -> Dict[str, float]:
        if block_on is not None:
            block_until_ready(block_on)
            self.tick()
        if not self._times:
            return {"steps": 0}
        times = sorted(self._times)
        mean = sum(times) / len(times)
        out = {
            "steps": float(len(times)),
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": times[len(times) // 2] * 1e3,
            "step_ms_p99": times[min(len(times) - 1,
                                     int(len(times) * 0.99))] * 1e3,
        }
        if self.batch_size:
            out["examples_per_s"] = self.batch_size / mean
        return out


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


def annotate(name: str):
    """Named trace span for the profiler timeline."""
    return torch.profiler.record_function(name)
