"""The program's spans on a profiler slice: which span launched each
device operation, and which span the host was in while the card idled.

The port marks its phases with spans (``utils/profiling.py::annotate``:
host events of function scope named as in ``SPANS``).  Each device
operation falls to the innermost span whose host interval holds the
runtime call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``: the call with the operation's correlation id).  A
call on a thread that holds no span (the autograd engine's, which runs a
step's backward) falls to the innermost span that any thread was in at
that moment, which is ``step.backward``.  The card is idle outside the
union of the device operations' intervals; a span's idle time is that
complement within the span's host intervals.

Events are plain tuples (``Host``, ``Dev``), so a test builds them by
hand; ``from_profile`` reads them from a ``torch.profiler.profile`` run
with CUDA activity.  ``METRICS`` holds the readers of the span metrics,
each returning None where the slice holds none of its spans (a program
without them).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

SPANS = ("serve.call", "serve.ids", "serve.bias", "serve.query",
         "serve.topk", "serve.to_host", "serve.finish",
         "step", "step.inputs", "step.forward", "step.backward",
         "step.reduce", "step.optimizer", "step.sparse_update",
         "step.metrics", "pipeline.epoch")


class Host(NamedTuple):
    name: str
    start: float          # microseconds
    end: float
    thread: int
    corr: int             # correlation id (a runtime call's: its launch's)


class Dev(NamedTuple):
    name: str
    start: float
    end: float
    corr: int             # the correlation id of its runtime call


@dataclass
class SpanSlice:
    calls: int
    host: List[Host] = field(default_factory=list)
    dev: List[Dev] = field(default_factory=list)


def from_profile(prof, calls: int) -> SpanSlice:
    """The host and device events of a finished ``torch.profiler.profile``
    (the raw Kineto events: ``FunctionEvent`` keeps no correlation id in
    every release).  Device-side copies of user-scope annotations are no
    device operations and are left out."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    out = SpanSlice(calls=calls)
    for e in res.events():
        s, t = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                out.dev.append(Dev(e.name(), s, t, e.correlation_id()))
        else:
            out.host.append(Host(e.name(), s, t, e.start_thread_id(),
                                 e.correlation_id()))
    return out


def _is_runtime(name: str) -> bool:
    return name.startswith("cu")


def is_sync(name: str) -> bool:
    """A runtime call that waits for the card: a synchronize, or a copy
    that is not asynchronous."""
    return _is_runtime(name) and ("Synchronize" in name or (
        "Memcpy" in name and "Async" not in name))


class _Spans:
    """The program's spans, for the innermost one holding a moment."""

    def __init__(self, host: List[Host]):
        spans = sorted((h for h in host if h.name in SPANS),
                       key=lambda h: h.start)
        self.all = spans
        self.starts = [h.start for h in spans]
        self.by_thread: Dict[int, Tuple[List[float], List[Host]]] = {}
        for h in spans:
            st, hs = self.by_thread.setdefault(h.thread, ([], []))
            st.append(h.start)
            hs.append(h)

    @staticmethod
    def _innermost(starts, spans, t) -> Optional[Host]:
        """The latest-starting span that holds ``t``: on one thread the
        spans nest, so that is the innermost."""
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[i].end >= t:
                return spans[i]
        return None

    def at(self, t: float, thread: int) -> Optional[str]:
        own = self.by_thread.get(thread)
        h = own and self._innermost(own[0], own[1], t)
        if h is None:
            h = self._innermost(self.starts, self.all, t)
        return None if h is None else h.name


def owners(sl: SpanSlice) -> List[Optional[str]]:
    """The span each device operation of ``sl.dev`` falls to (None: its
    launch is in no span, or the slice holds no runtime call of it)."""
    launch = {h.corr: h for h in sl.host if _is_runtime(h.name)}
    spans = _Spans(sl.host)
    out = []
    for d in sl.dev:
        h = launch.get(d.corr)
        out.append(None if h is None else spans.at(h.start, h.thread))
    return out


def busy(dev: List[Dev]) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in time order."""
    out: List[List[float]] = []
    for d in sorted(dev, key=lambda d: d.start):
        if out and d.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], d.end)
        else:
            out.append([d.start, d.end])
    return [(a, b) for a, b in out]


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    return busy([Dev("", a, b, 0) for a, b in iv])


def _overlap(xs, ys) -> float:
    """The length of the intersection of two unions of disjoint intervals,
    each in time order."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_us(sl: SpanSlice, name: str) -> Optional[float]:
    """Microseconds the card is idle while the host is in a span
    ``name`` (its intervals on every thread, merged)."""
    spans = _union([(h.start, h.end) for h in sl.host if h.name == name])
    if not spans:
        return None
    return sum(b - a for a, b in spans) - _overlap(spans, busy(sl.dev))


def device_us(sl: SpanSlice) -> Dict[Optional[str], float]:
    """Device microseconds of the operations by the span they fall to."""
    out: Dict[Optional[str], float] = {}
    for d, o in zip(sl.dev, owners(sl)):
        out[o] = out.get(o, 0.0) + (d.end - d.start)
    return out


def syncs(sl: SpanSlice, name: str) -> Optional[int]:
    """Runtime calls that wait for the card begun inside a span
    ``name``, on any thread."""
    spans = _union([(h.start, h.end) for h in sl.host if h.name == name])
    if not spans:
        return None
    starts = [a for a, _ in spans]
    n = 0
    for h in sl.host:
        if is_sync(h.name):
            i = bisect.bisect_right(starts, h.start) - 1
            n += i >= 0 and h.start <= spans[i][1]
    return n


def attributed_share(sl: SpanSlice) -> Optional[float]:
    """Percent of the slice's device op-seconds that fall to a span."""
    by = device_us(sl)
    total = sum(by.values())
    if total <= 0.0:
        return None
    return 100.0 * (total - by.get(None, 0.0)) / total


def _present(sl: SpanSlice, name: str) -> bool:
    return any(h.name == name for h in sl.host)


def _per_call_ms(us: Optional[float], sl: SpanSlice) -> Optional[float]:
    return None if us is None else us / 1e3 / sl.calls


def _device_ms(name: str) -> Callable[[SpanSlice], Optional[float]]:
    def read(sl):
        if not _present(sl, name):
            return None
        return _per_call_ms(device_us(sl).get(name, 0.0), sl)
    return read


def _step_syncs(sl: SpanSlice) -> Optional[float]:
    n = syncs(sl, "step")
    return None if n is None else n / sl.calls


METRICS: Dict[str, Callable[[SpanSlice], Optional[float]]] = {
    "serve.idle_ms": lambda sl: _per_call_ms(idle_us(sl, "serve.call"), sl),
    "serve.to_host.idle_ms":
        lambda sl: _per_call_ms(idle_us(sl, "serve.to_host"), sl),
    "step.forward.device_ms": _device_ms("step.forward"),
    "step.backward.device_ms": _device_ms("step.backward"),
    "step.optimizer.device_ms": _device_ms("step.optimizer"),
    "step.sparse_update.device_ms": _device_ms("step.sparse_update"),
    "step.syncs": _step_syncs,
}
