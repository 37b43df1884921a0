"""Feature/embedding cache with TTLs.

The port's copy of ``ncf_tpu/serving/cache.py`` (host Python only): an
in-memory TTL store by default and a Redis backend gated on import
(``redis_url``), pickled values, feature TTL 1 h and embedding TTL 24 h,
hit-rate accounting.  Every operation falls back to the local store when
Redis fails, and the backend is dropped after
``_MAX_REDIS_FAILURES`` failures in a row: that is the reference's
behaviour on a Redis outage.  One repair: with a ``metrics`` logger the
reference deadlocks at every hundredth lookup (``_record`` holds the lock
that ``hit_rate`` takes); the port writes the rate from the held counts.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ncf_tpu_torch.utils.logging import MetricsLogger


class TTLCache:
    """Thread-safe in-memory TTL cache (DummyCache analogue, with real
    expiry and LRU bound)."""

    def __init__(self, max_items: int = 100_000):
        self._store: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._max_items = max_items

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            exp = self._expiry.get(key)
            if exp is None:
                return None
            if exp < time.time():
                self._store.pop(key, None)
                self._expiry.pop(key, None)
                return None
            return self._store[key]

    def set(self, key: str, value: Any, ttl_s: float) -> None:
        with self._lock:
            if len(self._store) >= self._max_items:
                # drop oldest-expiring entries
                for k in sorted(self._expiry, key=self._expiry.get)[
                        : self._max_items // 10]:
                    self._store.pop(k, None)
                    self._expiry.pop(k, None)
            self._store[key] = value
            self._expiry[key] = time.time() + ttl_s

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)
            self._expiry.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


class FeatureCache:
    """User-feature + embedding cache with hit-rate accounting
    (cache.py:68-209 surface: get/set_features, get/set_embedding,
    invalidate, hit-rate metric emission)."""

    # consecutive redis failures before the backend is dropped for the
    # process lifetime (every op already falls back to the local store,
    # so a flapping Redis only costs latency — this caps even that)
    _MAX_REDIS_FAILURES = 8

    def __init__(
        self,
        feature_ttl_s: int = 3600,       # cache.py:86
        embedding_ttl_s: int = 86400,    # cache.py:87
        metrics: Optional[MetricsLogger] = None,
        redis_url: Optional[str] = None,
    ):
        self.feature_ttl = feature_ttl_s
        self.embedding_ttl = embedding_ttl_s
        self.metrics = metrics
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()
        self._redis = None
        self._redis_failures = 0
        if redis_url:
            try:
                import pickle

                import redis

                self._redis = redis.from_url(redis_url)
                self._pickle = pickle
            except ImportError:
                self._redis = None
        self._local = TTLCache()

    # ------------------------------------------------------------- helpers

    def _redis_failed(self, op: str, exc: Exception) -> None:
        """Network-boundary error policy: count the failure, fall back
        to the local store for this op, and drop the backend entirely after
        _MAX_REDIS_FAILURES consecutive errors.  Counter mutations take
        the lock — handlers run on ThreadingHTTPServer threads."""
        import logging

        log = logging.getLogger(__name__)
        log.warning("redis %s failed (%s); using local cache", op, exc)
        with self._lock:
            self._redis_failures += 1
            if self._redis_failures >= self._MAX_REDIS_FAILURES:
                log.error("redis disabled after %d consecutive failures",
                          self._redis_failures)
                self._redis = None

    def _redis_ok(self) -> None:
        with self._lock:
            self._redis_failures = 0

    def _get(self, key: str) -> Optional[Any]:
        if self._redis is not None:
            try:
                raw = self._redis.get(key)
                self._redis_ok()
                return (self._pickle.loads(raw)
                        if raw is not None else None)
            except Exception as e:  # noqa: BLE001 - network boundary
                self._redis_failed("get", e)
        return self._local.get(key)

    def _set(self, key: str, value: Any, ttl: float) -> None:
        if self._redis is not None:
            try:
                self._redis.setex(key, int(ttl), self._pickle.dumps(value))
                self._redis_ok()
                return
            except Exception as e:  # noqa: BLE001 - network boundary
                self._redis_failed("set", e)
        self._local.set(key, value, ttl)

    def _record(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
            total = self._hits + self._misses
            if self.metrics is not None and total % 100 == 0:
                # the rate from the counts held here: ``hit_rate()`` takes
                # this lock again, which deadlocks (the reference does so)
                self.metrics.write(kind="cache", hit_rate=self._hits / total,
                                   hits=self._hits, misses=self._misses)

    # -------------------------------------------------------------- public

    def get_features(self, customer_id: str) -> Optional[Dict]:
        val = self._get(f"features:{customer_id}")
        self._record(val is not None)
        return val

    def set_features(self, customer_id: str, features: Dict) -> None:
        self._set(f"features:{customer_id}", features, self.feature_ttl)

    def get_embedding(self, key: str):
        val = self._get(f"embedding:{key}")
        self._record(val is not None)
        return val

    def set_embedding(self, key: str, embedding) -> None:
        self._set(f"embedding:{key}", embedding, self.embedding_ttl)

    def invalidate(self, customer_id: str) -> None:
        # clear the backend as well as the local store, so no stale
        # entry stays live
        if self._redis is not None:
            try:
                self._redis.delete(f"features:{customer_id}",
                                   f"embedding:{customer_id}")
                self._redis_ok()
            except Exception as e:  # noqa: BLE001 - network boundary
                self._redis_failed("delete", e)
        self._local.delete(f"features:{customer_id}")
        self._local.delete(f"embedding:{customer_id}")

    def hit_rate(self) -> float:
        with self._lock:
            total = self._hits + self._misses
            return self._hits / total if total else 0.0
