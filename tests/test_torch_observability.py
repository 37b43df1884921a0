"""Port parity for ``utils/monitoring.py`` and ``utils/profiling.py``.

The dashboard and the alert policies of both packages, fed the same
records, give equal specs (apart from ``generated_at``) and the same
alerts.  ``trace`` writes a Chrome trace (``*.pt.trace.json``) holding
the ``annotate`` span, and raises without a card unless asked for the
CPU.
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ncf_tpu.utils import logging as jlogging  # noqa: E402
from ncf_tpu.utils import monitoring as jmon  # noqa: E402
from ncf_tpu_torch.utils import logging as tlogging  # noqa: E402
from ncf_tpu_torch.utils import monitoring as tmon  # noqa: E402
from ncf_tpu_torch.utils.profiling import annotate, trace  # noqa: E402


def _records():
    recs = [dict(kind="request", latency_ms=10.0 + (i * 7) % 23,
                 endpoint="x", ts=1000.0 + 0.25 * i) for i in range(40)]
    recs += [dict(kind="error", latency_ms=500.0, ts=1011.0),
             dict(kind="cache", hit_rate=0.15, ts=1012.0),
             dict(kind="val", ts=1013.0, **{"hr@10": 0.25}),
             dict(kind="request", latency_ms=900.0, ts=1014.0)]
    return recs


def _loggers(records):
    t, j = tlogging.MetricsLogger(), jlogging.MetricsLogger()
    for r in records:
        t.write(**r)
        j.write(**r)
    return t, j


@pytest.mark.parametrize("window", [1000, 10])
def test_dashboard_equal(window):
    t, j = _loggers(_records())
    ts, js = (tmon.build_dashboard(t, window=window),
              jmon.build_dashboard(j, window=window))
    ts.pop("generated_at")
    js.pop("generated_at")
    assert ts == js
    assert tmon.render_dashboard_text(ts) == jmon.render_dashboard_text(js)
    assert tmon.DEFAULT_PANELS == jmon.DEFAULT_PANELS
    lat = next(p for p in ts["panels"] if p["metric"] == "latency_ms")
    assert lat["values"]["p50"] > 0


def test_empty_dashboard_equal(tmp_path):
    ts = tmon.build_dashboard(tlogging.MetricsLogger())
    js = jmon.build_dashboard(jlogging.MetricsLogger())
    ts.pop("generated_at")
    js.pop("generated_at")
    assert ts == js
    assert "no data" in tmon.render_dashboard_text(ts)
    path = tmon.save_dashboard_json(ts, str(tmp_path / "d.json"))
    with open(path) as f:
        assert json.load(f) == ts


def _strip(alerts):
    return [{k: v for k, v in a.items() if k != "ts"} for a in alerts]


@pytest.mark.parametrize("n_records", [0, 3, 44])
def test_alerts_equal(n_records):
    t, j = _loggers(_records()[-n_records:] if n_records else [])
    t_fired, j_fired = [], []
    ta = tmon.AlertManager(t, notifier=t_fired.append).check()
    ja = jmon.AlertManager(j, notifier=j_fired.append).check()
    assert _strip(ta) == _strip(ja) and _strip(t_fired) == _strip(j_fired)
    assert [(p.name, p.metric, p.threshold, p.comparison, p.window,
             p.kind_filter) for p in tmon.DEFAULT_POLICIES] == [
        (p.name, p.metric, p.threshold, p.comparison, p.window,
         p.kind_filter) for p in jmon.DEFAULT_POLICIES]
    if n_records:
        assert "low-hr10" in {a["policy"] for a in ta}


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d, device="cpu") as out:
        assert out == d
        with annotate("test-span"):
            x = torch.ones((64, 64))
            (x @ x).sum()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(d)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test-span" for e in events)


def test_trace_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path / "p")):
            pass
    assert not (tmp_path / "p").exists()
