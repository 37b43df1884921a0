"""Where a cell's device time and idle time fall by program span.

    python3 benchmark/trace_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--calls <n>]

Sets the cell up as ``run.py`` does, runs its window for ``--seconds``
(untimed here: it settles the caches and clocks), then profiles
``--calls`` calls of the entry (the cell's ``trace_calls`` by default)
as ``trace.py::profile_slice`` does and prints one JSON line: the span
metrics of ``metrics/spans.py`` (``METRICS``), device and idle ms a call
by span, the share of device op-seconds that fall to a span, the runtime
calls that wait for the card by span and by the host op that makes them,
the slice's wall ms, device ops and busy share a call, and the sparse
update's counted rows.  Nothing is
judged and nothing of the result line of ``run.py`` is replaced; the
program without spans reads None for every span metric.
"""

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmark import run, spec  # noqa: E402
from benchmark.metrics import spans  # noqa: E402


def profile_spans(fn, calls: int):
    """(``spans.SpanSlice`` of ``calls`` calls of ``fn``, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return spans.from_profile(prof, calls), wall


def wait_sites(sl: spans.SpanSlice):
    """Runtime calls that wait for the card a call, by the innermost
    host op (not a span) that holds each on its thread."""
    ops = [h for h in sl.host
           if h.name not in spans.SPANS and not h.name.startswith("cu")]
    out = {}
    for h in sl.host:
        if spans.is_sync(h.name):
            held = [o for o in ops if o.thread == h.thread
                    and o.start <= h.start and h.end <= o.end]
            site = max(held, key=lambda o: o.start).name if held else "-"
            key = f"{site} / {h.name}"
            out[key] = out.get(key, 0.0) + 1.0 / sl.calls
    return out


def report(sl: spans.SpanSlice, wall: float, rows=None):
    per = lambda us: us / 1e3 / sl.calls
    names = sorted({h.name for h in sl.host if h.name in spans.SPANS})
    busy_us = sum(b - a for a, b in spans.busy(sl.dev))
    by_dev = spans.device_us(sl)
    out = {
        "calls": sl.calls,
        "wall_ms_per_call": wall * 1e3 / sl.calls,
        "ops_per_call": len(sl.dev) / sl.calls,
        "busy_share": 100.0 * busy_us / 1e6 / wall,
        "metrics": {k: f(sl) for k, f in spans.METRICS.items()},
        "attributed_share": spans.attributed_share(sl),
        "device_ms": {str(k): per(v) for k, v in sorted(
            by_dev.items(), key=lambda kv: -kv[1])},
        "idle_ms": {n: per(spans.idle_us(sl, n)) for n in names},
        "syncs": {n: spans.syncs(sl, n) / sl.calls for n in names},
        "wait_sites": wait_sites(sl),
    }
    if rows and rows.get("sparse_rows_processed"):
        out["rows"] = {k: rows[k] for k in ("sparse_rows_touched",
                                            "sparse_rows_processed")}
        out["metrics"]["sparse.useful_row_share"] = (
            100.0 * rows["sparse_rows_touched"]
            / rows["sparse_rows_processed"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--calls", type=int, default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.driver}").Driver(cell, args.seed, "cuda")
    driver.setup()
    driver.sync()
    run.window(driver, args.seconds)
    driver.mark()
    calls = args.calls or int(cell.traffic["trace_calls"])
    c0 = driver.counters()
    sl, wall = profile_spans(driver.call, calls)
    rows = run.per_call(c0, driver.counters(), calls)
    out = report(sl, wall, rows)
    out.update(cell=cell.name, seed=args.seed)
    print(json.dumps(out), flush=True)
    driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
