"""ModelServer — port of ``ncf_tpu/serving/server.py``.

Loads a checkpoint (the npy manifest format both packages share), exposes
user/product embeddings, pair predictions and full top-k retrieval backed
by the exact decomposition scorer (``SequenceRescoreScorer`` for
``use_sequence`` models, over ``user_history``) for ``advanced_ncf`` and
by ``BruteForceScorer`` for the other models (NCF, NeuMF), and coalesces
concurrent single-user requests into shared batched retrievals.  Runs on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.convert import params_to_device
from ncf_tpu_torch.models import get_model
from ncf_tpu_torch.serving.scorer import (
    AdvancedNCFScorer, BruteForceScorer, SequenceRescoreScorer)
from ncf_tpu_torch.train import checkpoint as ckpt_lib
from ncf_tpu_torch.utils.config import Config
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)


_STOP = object()


class _Coalescer:
    """Micro-batches concurrent single-user retrievals into one batched
    retrieval (logic unchanged from the reference).

    A dispatcher thread drains whatever requests are waiting (up to
    ``max_batch``), groups them by compatible scoring context ((k,
    temporal) or (k, hour)), pads each group to a fixed size bucket, and
    fans the rows back out to the blocked callers.
    """

    BUCKETS = (1, 8, 64)

    def __init__(self, server: "ModelServer", max_batch: int = 64,
                 dispatchers: int = 4):
        self.server = server
        self.max_batch = int(max_batch)
        # the bucket ladder must cover max_batch
        buckets = [b for b in self.BUCKETS if b < self.max_batch]
        b = 128
        while b < self.max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_batch)
        self.buckets = tuple(sorted(set(buckets)))
        self.q: "queue.Queue" = queue.Queue()
        self.batched_calls = 0
        self.batched_requests = 0
        self.direct_calls = 0       # low-concurrency shortcut count
        self._lock = threading.Lock()
        self._inflight = 0          # requests currently being scored
        # several dispatchers keep multiple coalesced batches in flight
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"ncf-coalescer-{i}")
            for i in range(max(1, int(dispatchers)))]
        for t in self._threads:
            t.start()

    def close(self) -> None:
        for _ in self._threads:
            self.q.put(_STOP)
        for t in self._threads:
            t.join(timeout=5)

    def submit(self, user_id: int, k: int, temporal: Optional[Dict],
               hour: Optional[int] = None,
               timeout_s: float = 30.0) -> Tuple[np.ndarray, np.ndarray]:
        # low-concurrency shortcut: with nothing queued and (almost)
        # nothing in flight, the queue hop only adds latency
        with self._lock:
            idle = self._inflight < 2 and self.q.empty()
            self._inflight += 1
        if idle:
            try:
                uids = np.asarray([user_id], np.int32)
                scorer = self.server.scorer
                if hour is not None:
                    scores, idxs = scorer.topk_for_users_hourly(
                        uids, hour=int(hour), k=k)
                else:
                    scores, idxs = scorer.topk_for_users(
                        uids, k=k, temporal=temporal)
                return scores[0], idxs[0]
            finally:
                with self._lock:
                    self._inflight -= 1
                    self.direct_calls += 1
        try:
            return self._submit_queued(user_id, k, temporal, hour, timeout_s)
        finally:
            with self._lock:
                self._inflight -= 1

    def _submit_queued(self, user_id, k, temporal, hour, timeout_s):
        if hour is not None:
            key = (int(k), "hourly", int(hour))
        else:
            key = (int(k), "plain",
                   tuple(sorted((temporal or {}).items())) or None)
        item = {"uid": int(user_id), "k": int(k), "key": key,
                "temporal": temporal, "hour": hour,
                "ev": threading.Event()}
        self.q.put(item)
        if not item["ev"].wait(timeout_s):
            raise TimeoutError("coalesced retrieval timed out")
        if "err" in item:
            raise item["err"]
        return item["scores"], item["items"]

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        while True:
            first = self.q.get()
            if first is _STOP:
                return
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self.q.put(_STOP)   # re-arm for close()
                    break
                batch.append(nxt)
            groups: Dict[tuple, list] = {}
            for it in batch:
                groups.setdefault(it["key"], []).append(it)
            for (k, kind, _), items in groups.items():
                uids = np.asarray([it["uid"] for it in items], np.int32)
                n = len(uids)
                b = self._bucket(n)
                if n < b:   # pad to the bucket
                    uids = np.concatenate(
                        [uids, np.full(b - n, uids[0], np.int32)])
                try:
                    scorer = self.server.scorer
                    if kind == "hourly":
                        scores, idxs = scorer.topk_for_users_hourly(
                            uids, hour=items[0]["hour"], k=k)
                    else:
                        scores, idxs = scorer.topk_for_users(
                            uids, k=k, temporal=items[0]["temporal"])
                    for i, it in enumerate(items):
                        it["scores"], it["items"] = scores[i], idxs[i]
                except Exception as e:  # noqa: BLE001 — fan the error out
                    for it in items:
                        it["err"] = e
                with self._lock:
                    self.batched_calls += 1
                    self.batched_requests += len(items)
                for it in items:
                    it["ev"].set()


def _template(cfg: Config):
    """Shape-only param tree for ``restore`` (no memory, no random draw)."""
    model = get_model(cfg.model.name)
    return model.init(torch.Generator(), cfg.model, device="meta")


class ModelServer:
    """Thread-safe model serving facade: ``get_user_embedding``,
    ``get_predictions``, ``recommend`` (retrieval) and ``reload``
    (checkpoint hot-swap)."""

    def __init__(
        self,
        cfg: Config,
        params=None,
        item_dept: Optional[np.ndarray] = None,
        item_cat: Optional[np.ndarray] = None,
        model_version: Optional[str] = None,
        user_history: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = get_model(cfg.model.name)
        self.model_version = model_version or cfg.serving.model_version
        self._lock = threading.Lock()
        self.item_dept = (torch.as_tensor(item_dept, device=self.device)
                          if item_dept is not None else None)
        self.item_cat = (torch.as_tensor(item_cat, device=self.device)
                         if item_cat is not None else None)
        self.user_history = (np.asarray(user_history, np.int32)
                             if user_history is not None else None)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init(gen, cfg.model)
            log.warning("ModelServer started with RANDOM params "
                        "(no checkpoint given)")
        self._set_params(params)
        self._coalescer: Optional[_Coalescer] = None
        if getattr(cfg.serving, "coalesce_requests", True):
            self._coalescer = _Coalescer(
                self, max_batch=getattr(cfg.serving, "coalesce_max_batch", 64),
                dispatchers=getattr(cfg.serving, "coalesce_dispatchers", 4))

    def close(self) -> None:
        if self._coalescer is not None:
            self._coalescer.close()
            self._coalescer = None

    # ------------------------------------------------------------ loading

    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_dir: Optional[str] = None,
                        device: DeviceLike = None, **kw) -> "ModelServer":
        """Load the best (or latest, or given) checkpoint under the
        configured directory."""
        directory = cfg.train.checkpoint_dir
        ckpt = (ckpt_dir
                or ckpt_lib.find_best(directory)
                or ckpt_lib.find_latest(directory))
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        params, manifest = _restore_params(cfg, ckpt, device)
        version = f"ckpt-{manifest.get('step', 0)}"
        return cls(cfg, params=params, model_version=version,
                   device=device, **kw)

    def _set_params(self, params) -> None:
        params = params_to_device(params, self.device)
        with self._lock:
            self.params = params
            # the sequence path makes the eval MLP logit user-dependent:
            # such models serve through retrieve-then-rescore; models
            # without the decomposition scan the catalog
            if self.cfg.model.name != "advanced_ncf":
                self.scorer = BruteForceScorer(
                    self.model, params, self.cfg.model, self.item_dept,
                    self.item_cat, user_history=self.user_history)
            elif self.cfg.model.use_sequence:
                self.scorer = SequenceRescoreScorer(
                    params, self.cfg.model, self.item_dept, self.item_cat,
                    user_history=self.user_history,
                    candidates=getattr(self.cfg.serving,
                                       "seq_rescore_candidates", 54),
                    retrieval=self.cfg.serving.retrieval)
            else:
                self.scorer = AdvancedNCFScorer(
                    params, self.cfg.model, self.item_dept, self.item_cat,
                    retrieval=self.cfg.serving.retrieval)

    def reload(self, ckpt_dir: str) -> None:
        """Hot-swap params from a checkpoint directory."""
        params, manifest = _restore_params(self.cfg, ckpt_dir, self.device)
        self._set_params(params)
        self.model_version = f"ckpt-{manifest.get('step', 0)}"
        log.info("model reloaded: %s", self.model_version)

    # ----------------------------------------------------------- serving

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.atleast_1d(ids), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def get_user_embedding(self, user_ids) -> Dict[str, np.ndarray]:
        """Normalized user embeddings."""
        out = self.model.get_user_embeddings(self.params, self._ids(user_ids))
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.no_grad()
    def get_product_embedding(self, item_ids) -> Dict[str, np.ndarray]:
        out = self.model.get_product_embeddings(
            self.params, self.cfg.model, self._ids(item_ids),
            self.item_dept, self.item_cat)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def get_predictions(self, user_id: int, item_ids,
                        temporal: Optional[Dict[str, int]] = None) -> np.ndarray:
        """Probability scores for one user against explicit candidates."""
        item_ids = np.atleast_1d(item_ids)
        users = np.full(len(item_ids), user_id, np.int32)
        if hasattr(self.scorer, "score_pairs"):
            return self.scorer.score_pairs(users, item_ids, temporal)
        # score the whole catalog, then map item id -> score
        scores, idxs = self.scorer.topk_for_users(
            np.asarray([user_id]), k=self.cfg.model.num_items,
            temporal=temporal)
        by_item = np.zeros(self.cfg.model.num_items, np.float32)
        by_item[idxs[0]] = scores[0]
        return by_item[np.asarray(item_ids)]

    def recommend(
        self,
        user_id: int,
        k: int = 10,
        temporal: Optional[Dict[str, int]] = None,
        exclude_items: Optional[List[int]] = None,
    ):
        """Full retrieval: top-k (scores, item_ids, ms) for one user.
        Concurrent exclusion-free calls coalesce into shared batched
        retrievals (serving.coalesce_requests)."""
        t0 = time.perf_counter()
        if exclude_items:
            exclude = np.full((1, len(exclude_items)), -1, np.int32)
            exclude[0, :] = exclude_items
            scores, idxs = self.scorer.topk_for_users(
                np.asarray([user_id], np.int32), k=k,
                temporal=temporal, exclude=exclude)
            scores, idxs = scores[0], idxs[0]
        elif self._coalescer is not None:
            scores, idxs = self._coalescer.submit(user_id, k, temporal)
        else:
            scores, idxs = self.scorer.topk_for_users(
                np.asarray([user_id], np.int32), k=k, temporal=temporal)
            scores, idxs = scores[0], idxs[0]
        ms = (time.perf_counter() - t0) * 1000
        return scores, idxs, ms

    def recommend_hourly(self, user_id: int, hour: int, k: int = 10):
        """Top-k under the demo's hour-of-day scoring; scorers without it
        take a temporal context with the given hour."""
        t0 = time.perf_counter()
        uids = np.asarray([user_id], np.int32)
        if not hasattr(self.scorer, "topk_for_users_hourly"):
            scores, idxs = self.scorer.topk_for_users(
                uids, k=k, temporal={"hour": int(hour), "day": 0,
                                     "month": 0, "day_of_year": 0})
            scores, idxs = scores[0], idxs[0]
        elif self._coalescer is not None:
            scores, idxs = self._coalescer.submit(
                user_id, k, None, hour=int(hour))
        else:
            scores, idxs = self.scorer.topk_for_users_hourly(
                uids, hour=int(hour), k=k)
            scores, idxs = scores[0], idxs[0]
        ms = (time.perf_counter() - t0) * 1000
        return scores, idxs, ms

    def recommend_batch(self, user_ids, k: int = 10,
                        temporal: Optional[Dict[str, int]] = None):
        t0 = time.perf_counter()
        scores, idxs = self.scorer.topk_for_users(
            np.asarray(user_ids, np.int32), k=k, temporal=temporal)
        ms = (time.perf_counter() - t0) * 1000
        return scores, idxs, ms


def _restore_params(cfg: Config, ckpt_dir: str, device: DeviceLike):
    template = _template(cfg)
    if _has_params_prefix(ckpt_dir):
        state, manifest = ckpt_lib.restore(ckpt_dir, {"params": template},
                                           device)
        return state["params"], manifest
    return ckpt_lib.restore(ckpt_dir, template, device)


def _has_params_prefix(ckpt_dir: str) -> bool:
    manifest = os.path.join(ckpt_dir, ckpt_lib.MANIFEST)
    try:
        with open(manifest) as f:
            leaves = json.load(f)["leaves"]
    except (OSError, ValueError, KeyError):
        return False
    return any(k.startswith("params.") for k in leaves)
