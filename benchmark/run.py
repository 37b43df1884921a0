"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``: from this process's start to the first timed call)
makes the cell's inputs and weights from the seed, builds the program's
entry and warms up every shape the mix uses.  The window then calls the
entry for ``--seconds`` seconds in a closed loop.  With ``--trace 1`` a
short slice after the window runs under ``torch.profiler`` and the
cell's per-layer metrics are read from it; otherwise the end-to-end
metrics are printed.  Then the program is freed and the reference judges
what the window produced (``reference/``).  The last line of standard
output is the result, one JSON object; the numbers compared, each with
its limit, are the last lines of standard error and the result's last
key.  Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; if JAX or the JAX package was loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.metrics import readers  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ncf_tpu")
GIB = float(1 << 30)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``ncf_tpu_torch`` is not ``ncf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_limits(cell: str):
    path = os.path.join(HERE, "reference", "limits", cell + ".json")
    with open(path) as f:
        return json.load(f)


def compared(numbers, limits):
    """{name: {"value", "limit"}} of each compared number, and whether
    every number is within its limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise RuntimeError(f"the check gave no {sorted(missing)}")
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return out, ok


def window(driver, seconds: float):
    """Call the entry in a closed loop for ``seconds``: (work done, the
    calls' host-clock seconds, the window's seconds to its last result)."""
    work, lat = 0, []
    t0 = time.perf_counter()
    now = t0
    while now - t0 < seconds:
        c0 = now
        work += driver.call()
        now = time.perf_counter()
        lat.append(now - c0)
    driver.sync()
    return work, lat, time.perf_counter() - t0


def per_call(before, after, calls):
    return {k: (after[k] - before[k]) / max(1, calls) for k in after}


def summarize(driver, work: int, lat, elapsed: float):
    """The end-to-end rate (all the window's work over all its time) and,
    for a driver with a latency metric, the 95th percentile over every
    call of the window."""
    out = {driver.unit_metric: work / elapsed}
    if driver.latency_metric:
        out[driver.latency_metric] = float(
            np.percentile(np.asarray(lat) * 1e3, 95))
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             overrides=None, t_start: float = T_START):
    """One run of ``cell``: the result (without the check of the modules
    loaded).  ``device`` and ``overrides`` (sizes and mix parameters) are
    for the CPU tests; a measured run takes the cell as it stands."""
    limits = load_limits(cell.name)
    on_card = torch.device(device).type == "cuda"
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.driver}").Driver(cell, seed, device,
                                                   overrides)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    driver.setup()
    driver.sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.3f} s, of which the driver's "
          f"{time.perf_counter() - t_setup:.3f} s", file=sys.stderr)

    c0 = driver.counters()
    work, lat, elapsed = window(driver, seconds)
    launches = per_call(c0, driver.counters(), len(lat))
    driver.mark()
    slc = None
    if trace:
        from benchmark import trace as trace_mod

        c1 = driver.counters()
        calls = int(cell.traffic["trace_calls"])
        slc = trace_mod.profile_slice(driver.call, calls)
        slice_launches = per_call(c1, driver.counters(), calls)
    driver.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}

    metrics = {}
    if trace:
        ctx = {"shapes": driver.shapes, "window_call_s": elapsed / len(lat),
               "launches": slice_launches}
        for m in cell.per_layer:
            value = readers.reader_of(m)(slc, ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        device_info.update(busy_s=slc.busy_s, window_s=slc.wall_s)
    else:
        found = {"setup_s": setup_s, "peak_mem_gib": peak / GIB,
                 **summarize(driver, work, lat, elapsed)}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": found[m.name], "unit": m.unit}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check(launches)
    print(f"detail numbers: {numbers!r}", file=sys.stderr)
    checks, ok = compared(numbers, limits)
    result = {"correct": ok, "attempted": len(lat), "failed": 0,
              "metrics": metrics, "device": device_info}
    if slc is not None:
        result["breakdown"] = slc.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"the benchmark loaded {bad}: JAX or the JAX package",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
