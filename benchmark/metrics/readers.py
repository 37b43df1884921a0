"""How a per-layer metric is read, and the readers that several metrics
share.

A metric is found by its name.  Where ``metrics/<metric>.py`` exists it
holds the metric's own reader, ``read(slc, ctx)``, and whatever it needs
besides (a roofline's kernel names and its bound), so that a new metric
is a new file.  Otherwise ``metrics/<metric>.json`` names one of the
shared readers below and gives its arguments.  A reader takes the traced
slice (``trace.Slice``) and the cell's context, and returns a number, or
None where it finds nothing to read (the harness then leaves the metric
out of the line).

The context (``ctx``) holds ``shapes`` (the cell's sizes, for
``counts``), ``window_call_s`` (the measured window's seconds a call or
step, from the untraced window) and ``launches`` (each launch counter's
launches a call or step over the slice).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import re
from typing import Any, Callable, Dict, Optional, Sequence

from benchmark import counts

HERE = os.path.dirname(os.path.abspath(__file__))


def own_module(name: str, root: str = HERE):
    """The module ``metrics/<name>.py`` (a name that is no Python
    identifier is loaded from its file)."""
    if name.isidentifier() and os.path.abspath(root) == HERE:
        return importlib.import_module(f"benchmark.metrics.{name}")
    path = os.path.join(root, name + ".py")
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_of(metric) -> Callable[[Any, Dict[str, Any]], Optional[float]]:
    """The function that reads ``metric`` (a ``spec.Metric``)."""
    found = metric.reader
    if "module" in found:
        return own_module(metric.name, os.path.dirname(found["module"])).read
    shared = SHARED[found["reader"]]
    return lambda slc, ctx: shared(slc, ctx, found)


def host_ms(slc, ctx: Dict[str, Any], args: Dict[str, Any]) -> Optional[float]:
    """Milliseconds a call that the card is not busy: the window's time a
    call less the slice's device busy time a call."""
    return (ctx["window_call_s"] - slc.busy_s / slc.calls) * 1e3


def idle_share(slc, ctx, args) -> Optional[float]:
    """Percent of the slice's wall time with no device operation."""
    return 100.0 * (1.0 - slc.busy_s / slc.wall_s)


def device_ops_per_call(slc, ctx, args) -> Optional[float]:
    """Device operations (kernels, copies, sets) a call or step."""
    return len(slc.ops) / slc.calls


def mfu(slc, ctx, args) -> Optional[float]:
    """Percent of the card's peak (``peak``, a ``counts.PEAK_FLOP_S``
    key): the useful FLOPs a call (``counts.<flops>``) over the window's
    time a call."""
    flops = getattr(counts, args["flops"])(ctx["shapes"])
    return 100.0 * flops / ctx["window_call_s"] / counts.PEAK_FLOP_S[
        args["peak"]]


SHARED = {f.__name__: f for f in (host_ms, idle_share, device_ops_per_call,
                                  mfu)}


def roofline(slc, ctx, kernels: Sequence[str], bound_s: float,
             launch_counter: str, launches: int) -> Optional[float]:
    """Percent of a kernel's roofline: ``bound_s`` (the least time of its
    work a call) over the device seconds a call of the ops whose names
    hold one of ``kernels``.  Nothing to read where no such op ran, or
    where the kernel's launch counter says it launched otherwise than
    the bound assumes (``launches`` a call)."""
    t = slc.device_s(kernels) / slc.calls
    if t <= 0.0 or ctx["launches"].get(launch_counter) != launches:
        return None
    return 100.0 * bound_s / t
