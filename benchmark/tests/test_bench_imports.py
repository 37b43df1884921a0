"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``ncf_tpu_torch`` is not ``ncf_tpu``), and
the reference loads nothing of the port."""

import os
import subprocess
import sys
import types

import pytest

from benchmark import run, spec

_HARNESS = """
import importlib, json, os, sys, pkgutil
sys.path.insert(0, {root!r})
import benchmark
mods = []
for info in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" in info.name:
        continue
    importlib.import_module(info.name)
    mods.append(info.name)
from benchmark import run, spec
for name, ov in {cells!r}.items():
    run.run_cell(spec.load_cell(name), 5, 0.2, False, "cpu", ov)
print(json.dumps({{"modules": mods,
                   "forbidden": run.forbidden_modules(),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.counts, benchmark.weights, benchmark.traffic.generate
import benchmark.reference.model, benchmark.reference.retrieve
import benchmark.reference.train, benchmark.reference.philox
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

CELLS = {
    "bigvocab-retrieve-b64": {
        "model": {"num_users": 3000, "num_items": 2000},
        "traffic": {"pool_calls": 4, "check_calls": 2,
                    "b5_launches_per_call": 0}},
    "ml1m-train-b524288": {
        "model": {"num_users": 200, "num_items": 150},
        "traffic": {"batch_size": 256, "n_interactions": 2000}},
}


def _last_json(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _last_json(_HARNESS.format(root=spec.ROOT, cells=CELLS))
    assert "benchmark.run" in got["modules"]
    assert "benchmark.drivers.train" in got["modules"]
    assert got["forbidden"] == []
    assert "ncf_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "ncf_tpu"} & set(got["top"])


def test_the_reference_loads_nothing_of_the_port():
    top = _last_json(_REFERENCE.format(root=spec.ROOT))
    assert "torch" in top
    assert not {"ncf_tpu_torch", "ncf_tpu", "jax"} & set(top)


@pytest.mark.parametrize("name,flagged", [("ncf_tpu_torch.ops", False),
                                          ("ncf_tpu", True),
                                          ("ncf_tpu.models", True),
                                          ("jaxlib", True),
                                          ("jax_tools", False)])
def test_modules_are_compared_by_whole_top_level_names(monkeypatch, name,
                                                       flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(run.forbidden_modules()) == flagged


def test_without_a_card_a_run_prints_no_result_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         "bigvocab-retrieve-b64", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
