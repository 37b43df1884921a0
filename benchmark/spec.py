"""Loading what a cell needs, by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration is ``configs/<config>.json``: the port's
``Config`` sections as run, with ``source``, ``reduced`` and ``assumed``.
The traffic mix is ``traffic/<traffic>.json``: the parameters that the
generator in ``traffic/generate.py`` reads, and the ``driver`` that runs
it (``drivers/<driver>.py``).  A per-layer metric is
``metrics/<metric>.py``, its own reader (for a roofline, with the kernel
names it sums and its bound), or else ``metrics/<metric>.json``, which
names a shared reader in ``metrics/readers.py`` and gives its arguments.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    """A file of the benchmark breaks the benchmark's file format."""


def check_name(name: Any, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what}: {name!r} is not a name (letters, digits, "
                        "_ . -, at most 64, not starting with . or -)")
    return name


def check_unit(unit: Any, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is not 1-16 of letters, "
                        "digits, _ / % . -")
    return unit


def _load_json(path: str, what: str) -> Dict[str, Any]:
    if not os.path.isfile(path):
        raise SpecError(f"{what}: no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]] = None
    layer: Optional[str] = None
    moves: Optional[str] = None
    reader: Optional[Dict[str, Any]] = None   # per-layer: its file

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _metric(entry: Dict[str, Any], kind: str, root: str) -> Metric:
    name = check_name(entry.get("name"), f"{kind} metric")
    unit = check_unit(entry.get("unit"), name)
    if entry.get("better") not in ("lower", "higher"):
        raise SpecError(f"{name}: better must be lower or higher")
    if entry.get("source") not in SOURCES:
        raise SpecError(f"{name}: unknown source {entry.get('source')!r}")
    reader = None
    if kind == "per_layer":
        own = os.path.join(root, "metrics", name + ".py")
        if os.path.isfile(own):
            reader = {"module": own}
        else:
            reader = _load_json(os.path.join(root, "metrics",
                                             name + ".json"), name)
            if "reader" not in reader:
                raise SpecError(f"{name}: metrics/{name}.json names no "
                                "reader")
    return Metric(name=name, unit=unit, better=entry["better"],
                  source=entry["source"],
                  workloads=entry.get("workloads"), layer=entry.get("layer"),
                  moves=entry.get("moves"), reader=reader)


def load_benchmark(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or os.path.join(ROOT, "BENCHMARK.json")
    return _load_json(path, "BENCHMARK.json")


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: str = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark()
    check_name(name, "workload")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    cfg_name = check_name(w["config"], f"{name}: config")
    tr_name = check_name(w["traffic"], f"{name}: traffic")
    cfg_entries = [c for c in bench["configs"] if c["name"] == cfg_name]
    if len(cfg_entries) != 1:
        raise SpecError(f"{name}: no config {cfg_name!r} in BENCHMARK.json")
    config = _load_json(os.path.join(ROOT, cfg_entries[0]["file"]),
                        cfg_name)
    traffic = _load_json(os.path.join(root, "traffic", tr_name + ".json"),
                         tr_name)
    if not isinstance(traffic.get("driver"), str) or not os.path.isfile(
            os.path.join(root, "drivers", traffic["driver"] + ".py")):
        raise SpecError(f"{tr_name}: no driver {traffic.get('driver')!r}")
    cell = Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic)
    for m in bench["end_to_end"]:
        metric = _metric(m, "end_to_end", root)
        if metric.applies_to(name):
            cell.end_to_end.append(metric)
    for m in bench["per_layer"]:
        metric = _metric(m, "per_layer", root)
        if metric.applies_to(name):
            cell.per_layer.append(metric)
    return cell


def port_config(config: Dict[str, Any], overrides: Dict[str, Any] = None):
    """The port's ``Config`` from a configuration file's sections, with
    the traffic's ``overrides`` (``{"train": {"batch_size": ...}}``)."""
    from ncf_tpu_torch.utils.config import Config

    sections = {}
    for sec in ("model", "data", "train", "serving", "mesh"):
        merged = dict(config.get(sec, {}))
        merged.update((overrides or {}).get(sec, {}))
        if merged:
            sections[sec] = merged
    return Config.from_dict(sections).validate()
