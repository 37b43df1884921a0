"""Dashboards + alert policies over the JSONL metrics stream.

Capability-parity with the reference's Cloud Monitoring scaffold
(reference: scripts/"3. monitoring"/create_dashboards.py:8-70+ — a
dashboard of request latency, cache hit rate, RPS and error panels — and
setup_alerts.py:7-60+ — threshold alert policies with a notification
channel; metric names declared in config.yaml:189-198).  Without a cloud
backend, the dashboard renders from MetricsLogger records to a JSON spec
/ terminal summary, and alert policies are threshold rules evaluated over
recent records with a pluggable notifier.

The port's copy of ``ncf_tpu/utils/monitoring.py``, over the port's
``MetricsLogger``: the same records give the same dashboard and alerts.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ncf_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger(__name__)

# The reference dashboard's four panels (create_dashboards.py).
DEFAULT_PANELS = [
    {"title": "Request latency (ms)", "metric": "latency_ms",
     "aggregations": ["p50", "p99", "mean"]},
    {"title": "Cache hit rate", "metric": "hit_rate",
     "aggregations": ["last"]},
    {"title": "Requests per second", "metric": "_rps",
     "aggregations": ["rate"]},
    {"title": "Errors", "metric": "_errors", "aggregations": ["count"]},
]


def _percentile(vals: List[float], q: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * q))]


def build_dashboard(metrics: MetricsLogger,
                    panels: Optional[List[Dict]] = None,
                    window: int = 1000) -> Dict[str, Any]:
    """Render the dashboard spec with current values
    (create_recommendation_dashboard analogue)."""
    records = metrics.recent(window)
    out_panels = []
    for panel in panels or DEFAULT_PANELS:
        metric = panel["metric"]
        values: Dict[str, float] = {}
        if metric == "_rps":
            ts = [r["ts"] for r in records if r.get("kind") == "request"]
            if len(ts) >= 2 and ts[-1] > ts[0]:
                values["rate"] = (len(ts) - 1) / (ts[-1] - ts[0])
            else:
                values["rate"] = 0.0
        elif metric == "_errors":
            values["count"] = float(
                sum(1 for r in records if r.get("kind") == "error"))
        else:
            vals = [float(r[metric]) for r in records if metric in r]
            if vals:
                for agg in panel["aggregations"]:
                    if agg == "p50":
                        values["p50"] = _percentile(vals, 0.50)
                    elif agg == "p99":
                        values["p99"] = _percentile(vals, 0.99)
                    elif agg == "mean":
                        values["mean"] = sum(vals) / len(vals)
                    elif agg == "last":
                        values["last"] = vals[-1]
        out_panels.append({**panel, "values": values})
    return {"displayName": "Recommendation Serving",
            "generated_at": time.time(), "panels": out_panels}


def render_dashboard_text(spec: Dict[str, Any]) -> str:
    lines = [f"== {spec['displayName']} =="]
    for p in spec["panels"]:
        vals = ", ".join(f"{k}={v:.4g}" for k, v in p["values"].items()) \
            or "no data"
        lines.append(f"  {p['title']:<28} {vals}")
    return "\n".join(lines)


@dataclass
class AlertPolicy:
    """One threshold rule (setup_monitoring_alerts analogue)."""

    name: str
    metric: str                  # record field, or _error_rate
    threshold: float
    comparison: str = "above"    # above | below
    window: int = 200
    kind_filter: Optional[str] = None

    def evaluate(self, records: List[Dict]) -> Optional[Dict]:
        recs = records[-self.window:]
        if self.kind_filter:
            recs = [r for r in recs if r.get("kind") == self.kind_filter]
        if self.metric == "_error_rate":
            total = len(recs)
            if total == 0:
                return None
            value = sum(1 for r in recs
                        if r.get("kind") == "error") / total
        else:
            vals = [float(r[self.metric]) for r in recs if self.metric in r]
            if not vals:
                return None
            value = sum(vals) / len(vals)
        firing = (value > self.threshold if self.comparison == "above"
                  else value < self.threshold)
        if firing:
            return {"policy": self.name, "metric": self.metric,
                    "value": value, "threshold": self.threshold,
                    "comparison": self.comparison, "ts": time.time()}
        return None


# The reference's default policies (setup_alerts.py thresholds +
# config.yaml:116-126 training metric thresholds).
DEFAULT_POLICIES = [
    AlertPolicy("high-latency", "latency_ms", 500.0, "above"),
    AlertPolicy("error-rate", "_error_rate", 0.05, "above"),
    AlertPolicy("low-cache-hit", "hit_rate", 0.2, "below"),
    AlertPolicy("low-hr10", "hr@10", 0.3, "below", kind_filter="val"),
]


class AlertManager:
    """Evaluate policies over a MetricsLogger; notify via callable
    (the email channel analogue — default: log.warning)."""

    def __init__(self, metrics: MetricsLogger,
                 policies: Optional[List[AlertPolicy]] = None,
                 notifier: Optional[Callable[[Dict], None]] = None):
        self.metrics = metrics
        self.policies = policies if policies is not None else list(
            DEFAULT_POLICIES)
        self.notifier = notifier or (
            lambda alert: log.warning("ALERT %s: %s=%.4g (threshold %s %s)",
                                      alert["policy"], alert["metric"],
                                      alert["value"], alert["comparison"],
                                      alert["threshold"]))
        self.history: List[Dict] = []

    def check(self) -> List[Dict]:
        records = self.metrics.recent(max(p.window for p in self.policies)
                                      if self.policies else 100)
        firing = []
        for p in self.policies:
            alert = p.evaluate(records)
            if alert is not None:
                firing.append(alert)
                self.history.append(alert)
                self.notifier(alert)
        return firing


def save_dashboard_json(spec: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)
    return path
