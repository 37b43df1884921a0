"""Structured JSONL metrics logging.

A copy of ``ncf_tpu/utils/logging.py``: one append-only JSONL stream
(training windows, validation results) that dashboards, tests and the
gate in ``chip_smoke.py`` can all parse, with an in-memory ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer; ``path=None`` keeps an in-memory
    ring (used by the API layer's /metrics endpoint)."""

    def __init__(self, path: Optional[str] = None, memory_limit: int = 4096):
        self.path = path
        self._lock = threading.Lock()
        self._memory: List[Dict[str, Any]] = []
        self._memory_limit = memory_limit
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, **record: Any) -> None:
        record.setdefault("ts", time.time())
        clean = {}
        for k, v in record.items():
            try:
                clean[k] = float(v) if hasattr(v, "__float__") and not isinstance(
                    v, (str, bool)) else v
            except (TypeError, ValueError):
                clean[k] = str(v)
        with self._lock:
            self._memory.append(clean)
            if len(self._memory) > self._memory_limit:
                self._memory = self._memory[-self._memory_limit:]
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(clean) + "\n")

    def recent(self, n: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._memory[-n:])

    def summary(self) -> Dict[str, Any]:
        """Aggregates for the /metrics endpoint (reference routes.py:180-195)."""
        with self._lock:
            records = list(self._memory)
        if not records:
            return {"count": 0}
        latencies = [r["latency_ms"] for r in records if "latency_ms" in r]
        out: Dict[str, Any] = {"count": len(records)}
        if latencies:
            latencies.sort()
            out["latency_ms_p50"] = latencies[len(latencies) // 2]
            out["latency_ms_p99"] = latencies[min(len(latencies) - 1,
                                                  int(len(latencies) * 0.99))]
            out["latency_ms_mean"] = sum(latencies) / len(latencies)
        errors = [r for r in records if r.get("kind") == "error"]
        out["errors"] = len(errors)
        return out
