"""The readings that a cell's limits are set from, besides the program's
own (which every run prints): the control's, and for a training cell
the faults', at the cell's own size, one seed after another.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13

The control is the reference computed one precision below the
configuration's, put in the program's place; it runs no program and
times nothing.  Each seed's readings are a JSON line on standard output.
"""

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    mod = importlib.import_module(f"benchmark.drivers.{cell.driver}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings = mod.Driver(cell, seed, args.device).control()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
