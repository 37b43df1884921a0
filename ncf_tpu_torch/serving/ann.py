"""ProductSearch: exact nearest-neighbor retrieval over item embeddings.

Port of ``ncf_tpu/serving/ann.py``: exact cosine or dot retrieval with
the surface of a vector-search endpoint (``find_neighbors``,
``get_index_stats``, ``refresh``).  Embeddings and queries are
normalized on the host as in the reference; the table lives on the
device as one tensor and every query goes through
``ops/topk.py::topk_scores(impl=self.impl)``: on the card ``"auto"``
sends a large catalog to the streaming kernel (B5), ``"pallas"`` to the
exact kernel (B8) and ``"segmented"`` to the segmented kernel (B9).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.ops.topk import topk_scores
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device


class ProductSearch:
    """Exact nearest-neighbor retrieval over item embeddings."""

    def __init__(
        self,
        embeddings: np.ndarray,         # [I, D]
        ids: Optional[List] = None,      # external ids, default 0..I-1
        metric: str = "cosine",         # cosine | dot
        impl: str = "auto",
        device: DeviceLike = None,
    ):
        if metric not in ("cosine", "dot"):
            raise ValueError(f"unknown metric {metric!r}")
        self.device = resolve_device(device)
        self.metric = metric
        self.impl = impl
        self._lock = threading.Lock()
        self.refresh(embeddings, ids)

    def refresh(self, embeddings: np.ndarray,
                ids: Optional[List] = None) -> None:
        """Swap the index contents."""
        emb = np.asarray(embeddings, np.float32)
        if self.metric == "cosine":
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            emb = emb / np.maximum(norms, 1e-12)
        table = torch.from_numpy(np.ascontiguousarray(emb)).to(self.device)
        with self._lock:
            self._emb = table
            self._ids = list(ids) if ids is not None else list(range(len(emb)))
            self._refreshed_at = time.time()
            self._queries = 0

    @torch.no_grad()
    def find_neighbors(
        self,
        queries: np.ndarray,            # [B, D] or [D]
        num_neighbors: int = 10,
    ) -> List[List[Tuple[object, float]]]:
        """Top-k neighbors per query: a list of (id, similarity) lists."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        with self._lock:
            emb, ids = self._emb, self._ids
            self._queries += q.shape[0]
        vals, idxs = topk_scores(
            torch.from_numpy(np.ascontiguousarray(q)).to(self.device), emb,
            num_neighbors, impl=self.impl)
        vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
        return [
            [(ids[int(i)], float(v)) for v, i in zip(vrow, irow)]
            for vrow, irow in zip(vals, idxs)
        ]

    def get_index_stats(self) -> Dict:
        """Index metadata for GET /metrics."""
        with self._lock:
            return {
                "num_items": int(self._emb.shape[0]),
                "dims": int(self._emb.shape[1]),
                "metric": self.metric,
                "refreshed_at": self._refreshed_at,
                "queries_served": self._queries,
            }
