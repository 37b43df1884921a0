"""BENCHMARK.json and the files the harness finds by name.

Run: ``python -m pytest benchmark/tests -q`` (CPU; the tests marked
``cuda`` run only where a card is present).
"""

import json
import os
import re

import pytest

from benchmark import spec, weights
from benchmark.metrics import readers

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["model"]["name"] == "advanced_ncf"
    assert os.path.isfile(os.path.join(spec.HERE, "reference", "limits",
                                       name + ".json"))
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(readers.reader_of(m)), m.name
        assert m.moves in names, (m.name, m.moves)


def test_the_file_keeps_its_format():
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells at this length fits in 43,200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        spec.check_name(c["name"], "config")
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            spec.check_name(k, "reduced")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            spec.check_name(w[k], k)
        assert w["chips"] == 1
        assert LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert LINE.match(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reported, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", "", ".lead",
                                 "x" * 65, "café"])
def test_a_bad_name_is_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "test")


@pytest.mark.parametrize("bad", ["tokens per second", "", "x" * 17,
                                 "µs"])
def test_a_bad_unit_is_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad, "test")


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("config", ["advanced_ncf_ml1m",
                                    "advanced_ncf_bigvocab"])
def test_the_weights_have_the_port_s_layout(config):
    import torch

    from ncf_tpu_torch.models import advanced_ncf

    with open(os.path.join(spec.HERE, "configs", config + ".json")) as f:
        cfg = spec.port_config(json.load(f))
    meta = advanced_ncf.init(torch.Generator(), cfg.model, device="meta")
    ours = weights.layout(cfg.model)
    got = {p: tuple(s[1]) for p, s in weights.leaves(ours)}
    want = {p: tuple(t.shape) for p, t in weights.leaves(meta)}
    assert got == want


def test_a_metric_with_a_file_of_its_own_is_read_by_name(tmp_path):
    """A new per-layer metric is new files only: ``metrics/<name>.py``
    holds its reader, whatever its name."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "zz.share.py").write_text(
        "def read(slc, ctx):\n    return ctx['window_call_s'] * 2\n")
    entry = {"name": "zz.share", "unit": "%", "better": "higher",
             "source": "device_trace", "layer": "x", "moves": "setup_s"}
    metric = spec._metric(entry, "per_layer", str(tmp_path))
    assert readers.reader_of(metric)(None, {"window_call_s": 1.5}) == 3.0
    entry["name"] = "zz_absent"
    with pytest.raises(spec.SpecError):
        spec._metric(entry, "per_layer", str(tmp_path))
