"""The traced slice: ``torch.profiler`` over a few calls of the timed
entry, right after the measured window, kept in memory (nothing is
written to disk).

``profile_slice`` returns what the per-layer readers and the result's
``breakdown`` read: the slice's wall seconds, the device operations
(name, start, end in microseconds), their busy union, and the idle gaps
between them, each named by the innermost host operation that was
running when the gap began.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10


@dataclass
class Slice:
    calls: int
    wall_s: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    busy_s: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_s(self, names) -> float:
        """Device seconds of the ops whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in names)) / 1e6

    def breakdown(self) -> Dict[str, List[List]]:
        by_op: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        by_host: Dict[str, float] = {}
        for n, g in self.gaps:
            by_host[n] = by_host.get(n, 0.0) + g
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width]


def _name_gaps(host, gaps) -> List[Tuple[str, float]]:
    """Each gap (start, end in us, in time order) named by the host
    operation running at its start that began last (the innermost), in
    one sweep over the host operations sorted by start."""
    host = sorted(host, key=lambda x: x[1])
    active, i, out = [], 0, []
    for a, b in gaps:
        while i < len(host) and host[i][1] <= a:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] > a]
        name = max(active, key=lambda h: h[1])[0] if active else "host idle"
        out.append((name, (b - a) / 1e6))
    return out


def profile_slice(fn: Callable[[], object], calls: int) -> Slice:
    """Profile ``calls`` calls of ``fn`` (the card synchronised before
    and after); raises where the trace holds no device operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            ops.append((_short(e.name), *rng))
        else:
            host.append((_short(e.name), *rng))
    if not ops:
        raise RuntimeError("the profiler's trace holds no device operation")
    ops.sort(key=lambda x: x[1])
    busy, gaps = 0.0, []
    cur_s, cur_e = ops[0][1], ops[0][2]
    for _, s, e in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return Slice(calls=calls, wall_s=wall, ops=ops, busy_s=busy / 1e6,
                 gaps=_name_gaps(host, gaps))
