"""HTTP JSON API over the port's ``ModelServer``, on the stdlib server.

Port of ``ncf_tpu/api/app.py``, with the same routes, statuses and JSON:

- POST /api/v1/recommendations        — single-customer top-k
- POST /api/v1/recommendations/batch  — up to 100 customers
- POST /api/v1/intelligence           — top-k + the dashboard payload
- GET  /health                        — liveness
- GET  /metrics                       — latency aggregates + cache
- POST /api/v1/index/refresh          — reload params or rebuild tables
- GET  /demo                          — the web demo page

``RecommendationAPI.dispatch`` is the transport-free error boundary: 404
for an unknown route or customer, 422 for a body that fails its DTO
(``serving/dtos.py``, the port's stand-in for pydantic), 500 for any
other exception, each recorded in the ``MetricsLogger`` (5xx as
``kind="error"``).  The handler adds 400 for a body that is not JSON and
``Cache-Control: no-store`` on every answer.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from ncf_tpu_torch.serving.cache import FeatureCache
from ncf_tpu_torch.serving.dtos import (
    BatchRecommendationRequest,
    BatchRecommendationResponse,
    ErrorResponse,
    IntelligenceRequest,
    ProductMetadata,
    ProductRecommendation,
    RecommendationRequest,
    RecommendationResponse,
    ValidationError,
)
from ncf_tpu_torch.serving.features import FeatureProcessor
from ncf_tpu_torch.serving.intelligence import intelligence_report
from ncf_tpu_torch.serving.server import ModelServer
from ncf_tpu_torch.train import checkpoint as ckpt_lib
from ncf_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger(__name__)


class RecommendationAPI:
    """Route logic, transport-independent (testable without sockets)."""

    def __init__(
        self,
        server: ModelServer,
        processor: Optional[FeatureProcessor] = None,
        cache: Optional[FeatureCache] = None,
        metrics: Optional[MetricsLogger] = None,
    ):
        self.server = server
        self.processor = processor
        if cache is None:
            scfg = server.cfg.serving
            cache = FeatureCache(
                feature_ttl_s=scfg.cache_feature_ttl_s,
                embedding_ttl_s=scfg.cache_embedding_ttl_s,
                redis_url=scfg.redis_url or None,
            )
        self.cache = cache
        self.metrics = metrics or MetricsLogger()
        self._start_time = time.time()

    # ---------------------------------------------------------- helpers

    @staticmethod
    def _normalize_context(context):
        """Partial temporal contexts default missing keys to 0 and drop
        unknown keys (a {'hour': 9}-only request must not 500)."""
        if context is None:
            return None
        return {k: int(context.get(k, 0))
                for k in ("hour", "day", "month", "day_of_year")}

    def _resolve_customer(self, customer_id: str) -> int:
        """Map an external customer id to a model index."""
        try:
            idx = int(customer_id)
        except ValueError as e:
            raise KeyError(f"unknown customer {customer_id!r}") from e
        if not 0 <= idx < self.server.cfg.model.num_users:
            raise KeyError(f"customer {customer_id!r} out of range")
        return idx

    def _features_for(self, customer_id: str) -> Optional[Dict]:
        """cache -> feature store."""
        feats = self.cache.get_features(customer_id)
        if feats is None and self.processor is not None:
            feats = self.processor.get_features(
                self._resolve_customer(customer_id))
            self.cache.set_features(customer_id, feats)
        return feats

    # ----------------------------------------------------------- routes

    def recommendations(self, req: RecommendationRequest) -> RecommendationResponse:
        """POST /api/v1/recommendations."""
        t0 = time.perf_counter()
        uid = self._resolve_customer(req.customer_id)
        feats = self._features_for(req.customer_id)

        exclude = None
        if req.exclude_purchased and feats is not None:
            exclude = [h["item_id"] for h in feats.get("sequence", [])]

        scores, items, _ = self.server.recommend(
            uid, k=req.num_recommendations,
            temporal=self._normalize_context(req.context),
            exclude_items=exclude)

        enriched = (self.processor.enrich_products(items, scores)
                    if self.processor is not None else None)
        recs = []
        for rank, (score, item) in enumerate(zip(scores, items)):
            meta = expl = None
            if enriched is not None:
                e = enriched[rank]
                meta = ProductMetadata(
                    name=e["name"], department=e["department"],
                    category=e["category"], avg_price=e["avg_price"],
                    popularity_score=e["popularity_score"])
                expl = e["explanation"]
            recs.append(ProductRecommendation(
                product_id=str(int(item)), score=float(score),
                rank=rank + 1, metadata=meta, explanation=expl))
        return RecommendationResponse(
            customer_id=req.customer_id,
            recommendations=recs,
            model_version=self.server.model_version,
            inference_time_ms=(time.perf_counter() - t0) * 1000)

    def recommendations_batch(
        self, req: BatchRecommendationRequest
    ) -> BatchRecommendationResponse:
        """POST /api/v1/recommendations/batch: one batched device call
        for all customers."""
        t0 = time.perf_counter()
        uids = [self._resolve_customer(c) for c in req.customer_ids]
        scores, idxs, _ = self.server.recommend_batch(
            uids, k=req.num_recommendations,
            temporal=self._normalize_context(req.context))
        results = []
        for row, cid in enumerate(req.customer_ids):
            recs = [
                ProductRecommendation(
                    product_id=str(int(idxs[row, r])),
                    score=float(scores[row, r]), rank=r + 1)
                for r in range(idxs.shape[1])
            ]
            results.append(RecommendationResponse(
                customer_id=cid, recommendations=recs,
                model_version=self.server.model_version,
                inference_time_ms=0.0))
        return BatchRecommendationResponse(
            results=results,
            total_time_ms=(time.perf_counter() - t0) * 1000)

    def intelligence(self, req: IntelligenceRequest) -> Dict:
        """POST /api/v1/intelligence: recommendations (under the
        hour-of-day scoring when ``hour`` is set) and the dashboard
        payload."""
        uid = self._resolve_customer(req.customer_id)
        if req.hour is not None:
            scores, items, ms = self.server.recommend_hourly(
                uid, hour=req.hour, k=req.num_recommendations)
        else:
            scores, items, ms = self.server.recommend(
                uid, k=req.num_recommendations)
        # a small user sample stabilizes the head-importance statistic
        sample = np.arange(
            min(32, self.server.cfg.model.num_users), dtype=np.int32)
        hist = None
        if (self.server.user_history is not None
                and self.server.cfg.model.use_sequence):
            # sequence models: which recent items drove this user's
            # recommendations (trained-attention explanations)
            hist = np.asarray(self.server.user_history[uid])
        report = intelligence_report(
            self.server.params, self.server.cfg.model, uid,
            scores, items, sample_users=sample, history=hist)
        return {
            "customer_id": req.customer_id,
            "hour": req.hour,
            "inference_time_ms": ms,
            "model_version": self.server.model_version,
            "recommendations": [
                {"product_id": str(int(it)), "score": float(sc),
                 "rank": r + 1}
                for r, (sc, it) in enumerate(zip(scores, items))],
            "intelligence": report,
        }

    def demo_page(self) -> str:
        """GET /demo: the self-contained web demo page."""
        from ncf_tpu_torch.api.demo_page import DEMO_HTML

        return DEMO_HTML

    def health(self) -> Dict:
        """GET /health."""
        return {"status": "healthy",
                "model_version": self.server.model_version,
                "uptime_s": round(time.time() - self._start_time, 1)}

    def metrics_endpoint(self) -> Dict:
        """GET /metrics: serving aggregates + cache."""
        out = self.metrics.summary()
        out["cache_hit_rate"] = self.cache.hit_rate()
        out["model_version"] = self.server.model_version
        out["num_items"] = self.server.cfg.model.num_items
        out["num_users"] = self.server.cfg.model.num_users
        coal = getattr(self.server, "_coalescer", None)
        if coal is not None:
            out["coalesced_batches"] = coal.batched_calls
            out["coalesced_requests"] = coal.batched_requests
            out["direct_requests"] = coal.direct_calls
            if coal.batched_calls:
                out["avg_coalesced_batch"] = round(
                    coal.batched_requests / coal.batched_calls, 2)
        return out

    def index_refresh(self, body: Dict) -> Dict:
        """POST /api/v1/index/refresh: reload params from a checkpoint (or
        rebuild the scorer's tables in place)."""
        ckpt = body.get("checkpoint_dir") if body else None
        if ckpt is None:
            ckpt = (ckpt_lib.find_best(self.server.cfg.train.checkpoint_dir)
                    or ckpt_lib.find_latest(self.server.cfg.train.checkpoint_dir))
        if ckpt:
            self.server.reload(ckpt)
            return {"status": "reloaded", "checkpoint": ckpt,
                    "model_version": self.server.model_version}
        self.server.scorer.refresh(self.server.params)
        return {"status": "refreshed", "model_version": self.server.model_version}

    # -------------------------------------------------------- dispatcher

    def dispatch(self, method: str, path: str,
                 body: Optional[Dict]) -> Tuple[int, Dict]:
        """(status_code, payload) for one request; transport-agnostic."""
        t0 = time.perf_counter()
        endpoint = f"{method} {path}"
        try:
            if method == "GET" and path == "/health":
                status, payload = 200, self.health()
            elif method == "GET" and path == "/metrics":
                status, payload = 200, self.metrics_endpoint()
            elif method == "POST" and path == "/api/v1/recommendations":
                resp = self.recommendations(
                    RecommendationRequest.from_dict(body or {}))
                status, payload = 200, resp.to_dict()
            elif method == "POST" and path == "/api/v1/recommendations/batch":
                resp = self.recommendations_batch(
                    BatchRecommendationRequest.from_dict(body or {}))
                status, payload = 200, resp.to_dict()
            elif method == "POST" and path == "/api/v1/intelligence":
                status, payload = 200, self.intelligence(
                    IntelligenceRequest.from_dict(body or {}))
            elif method == "POST" and path == "/api/v1/index/refresh":
                status, payload = 200, self.index_refresh(body or {})
            else:
                status, payload = 404, ErrorResponse(
                    error="not found", detail=path,
                    status_code=404).to_dict()
        except ValidationError as e:
            status, payload = 422, ErrorResponse(
                error="validation error", detail=str(e),
                status_code=422).to_dict()
        except KeyError as e:
            status, payload = 404, ErrorResponse(
                error="not found", detail=str(e), status_code=404).to_dict()
        except Exception as e:  # noqa: BLE001 — error boundary
            log.exception("request failed: %s", endpoint)
            status, payload = 500, ErrorResponse(
                error="internal error", detail=str(e),
                status_code=500).to_dict()

        latency_ms = (time.perf_counter() - t0) * 1000
        self.metrics.write(
            kind="request" if status < 500 else "error",
            endpoint=endpoint, status=status, latency_ms=latency_ms)
        return status, payload


def make_handler(api: RecommendationAPI):
    class Handler(BaseHTTPRequestHandler):
        # request/response logging
        def log_message(self, fmt, *args):
            log.info("%s %s", self.address_string(), fmt % args)

        def _send(self, status: int, raw: bytes, content_type: str):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.send_header("Cache-Control", "no-store, max-age=0")
            self.end_headers()
            self.wfile.write(raw)

        def _respond(self, status: int, payload: Dict):
            self._send(status, json.dumps(payload).encode(),
                       "application/json")

        def do_GET(self):
            if self.path.rstrip("/") == "/demo":
                self._send(200, api.demo_page().encode(),
                           "text/html; charset=utf-8")
                return
            status, payload = api.dispatch("GET", self.path, None)
            self._respond(status, payload)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = None
            if length:
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self._respond(400, {"error": "invalid JSON",
                                        "status_code": 400})
                    return
            status, payload = api.dispatch("POST", self.path, body)
            self._respond(status, payload)

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's backlog of 5 refuses connections beyond it when many
    # clients connect at once
    request_queue_size = 256
    daemon_threads = True


def serve(api: RecommendationAPI, host: str = "127.0.0.1",
          port: int = 8080, background: bool = False) -> ThreadingHTTPServer:
    """Start the HTTP server.  ``background=True`` serves from a daemon
    thread and returns at once (stop it with ``shutdown()`` and
    ``server_close()``); otherwise it serves until interrupted."""
    httpd = _Server((host, port), make_handler(api))
    host, port = httpd.server_address[:2]
    if background:
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        log.info("API serving on %s:%d (background); web demo at "
                 "http://%s:%d/demo", host, port, host, port)
    else:
        log.info("API serving on %s:%d; web demo at http://%s:%d/demo",
                 host, port, host, port)
        httpd.serve_forever()
    return httpd
