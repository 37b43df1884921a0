"""Exact AdvancedNCF top-k retrieval via the dot-product decomposition.

Port of ``ncf_tpu/serving/scorer.py::AdvancedNCFScorer``.  In eval mode
the AdvancedNCF logit decomposes exactly into a dot product plus a
per-item bias:

    logit(u, i, t) = q_u . v_i + b_i(t)

      q_u    = wf1 * (LN(u_mf) o w_mf)        [user query vector, d_mf]
      v_i    = LN(i_mf)                        [item vector, d_mf]
      b_i(t) = wf1*b_mf + wf2*mlp_pred(i,t) + b_final

so full-model top-k retrieval is a streaming top-k over the item table
(``ops.topk``).  Large catalogs on the card go through the hand-written
streaming kernel against a once-prepared table per bias context.

Each request makes one device-to-host copy: the values and the ids come
back together in one ``.cpu()``.

Not ported yet: the ``int8``/``int8-fast`` presets (their kernel is the
TPU's ``topk_scores_streaming_int8``), ``SequenceRescoreScorer`` and
``BruteForceScorer``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.models import advanced_ncf, temporal as temporal_mod
from ncf_tpu_torch.models.layers import dense, layer_norm, mlp_tower
from ncf_tpu_torch.ops.topk import PreparedItems, prepare_items, topk_scores
from ncf_tpu_torch.utils.config import ModelConfig
from ncf_tpu_torch.utils.device import torch_dtype

# the prepared table only pays when retrieval takes the streaming kernel
# (large catalogs on the card); below this the dense path wins anyway
_PREPARE_MIN_ITEMS = 1 << 16
# each prepared table is a full catalog copy (1 GB at 4M x 64 f32): cap
# the cache far below the bias cache's 32
_PREPARED_CACHE_SIZE = 4
# item rows per tower pass when building the bias: bounds the [rows, 256]
# activations (4 GB at 4M items in one pass); row-wise ops, same result
_BIAS_CHUNK_ROWS = 1 << 20


def _context_key(temporal: Optional[Dict[str, int]]) -> Tuple:
    if temporal is None:
        return ()
    return tuple(sorted((k, int(v)) for k, v in temporal.items()))


class AdvancedNCFScorer:
    """Exact full-model top-k retrieval for AdvancedNCF via the
    dot-product + item-bias decomposition."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        item_dept: Optional[torch.Tensor] = None,
        item_cat: Optional[torch.Tensor] = None,
        impl: str = "auto",
        bias_cache_size: int = 32,
        retrieval: str = "exact",
    ):
        """``retrieval`` picks the streaming kernel's recall/speed point:
        'exact' (segments of 128, top 2 each) or 'fast' (64, top 1).
        Small catalogs use the exact dense path under every preset.  The
        tables live on the device of ``params``."""
        if retrieval in ("int8", "int8-fast"):
            raise NotImplementedError(
                f"retrieval={retrieval!r}: the int8 tier is not ported yet")
        if retrieval not in ("exact", "fast"):
            raise ValueError(f"unknown retrieval preset: {retrieval!r}")
        if cfg.use_sequence:
            raise NotImplementedError(
                "use_sequence models (SequenceRescoreScorer) are not "
                "ported yet")
        self._retrieval = retrieval
        self._seg_width, self._seg_top = {
            "exact": (128, 2), "fast": (64, 1)}[retrieval]
        self.cfg = cfg
        self.impl = impl
        self.item_dept = item_dept
        self.item_cat = item_cat
        self._bias_cache: Dict[Tuple, torch.Tensor] = {}
        self._prepared_cache: Dict[Tuple, PreparedItems] = {}
        self._bias_cache_size = bias_cache_size
        # the coalescer's dispatcher threads share the caches: fill and
        # evict under one lock (re-entrant: the hourly bias builds the
        # hour modulation)
        self._cache_lock = threading.RLock()
        self.refresh(params)

    # ------------------------------------------------------------ tables

    @torch.no_grad()
    def refresh(self, params) -> None:
        """(Re)build the static item/user tables from model params."""
        self.params = params
        self.device = params["item_emb"].device
        cfg = self.cfg
        wf = params["final"]["w"][:, 0]            # [2]: (mf, mlp) fusion
        self._wf1 = wf[0]
        self._wf2 = wf[1]
        self._bf = params["final"]["b"][0]
        self._bmf = params["mf_out"]["b"][0]

        dmf = cfg.mf_dim
        self.item_vecs = layer_norm(params["mf_norm"],
                                    params["item_emb"][:, :dmf])
        w_mf = params["mf_out"]["w"][:, 0]         # [dmf]
        self.user_queries = (
            layer_norm(params["mf_norm"], params["user_emb"][:, :dmf])
            * w_mf[None, :] * self._wf1)
        with self._cache_lock:
            self._bias_cache.clear()
            self._prepared_cache.clear()

    def _prepared(self, key: Tuple, bias: torch.Tensor):
        """Cached prepared item table for the streaming kernel (one per
        bias context), or None where retrieval takes another path."""
        if (self.cfg.num_items < _PREPARE_MIN_ITEMS
                or self.impl not in ("auto", "streaming")
                or self.device.type != "cuda"):
            return None
        with self._cache_lock:
            if key not in self._prepared_cache:
                if len(self._prepared_cache) >= _PREPARED_CACHE_SIZE:
                    self._prepared_cache.pop(next(iter(self._prepared_cache)))
                self._prepared_cache[key] = prepare_items(
                    self.item_vecs, bias, seg_width=self._seg_width)
            return self._prepared_cache[key]

    def _tower_logit(self, item_mlp: torch.Tensor,
                     t_row: Optional[torch.Tensor]) -> torch.Tensor:
        """MLP-path logit [I] for item vectors ``item_mlp`` [I, dm] under
        one temporal row ``t_row`` [dt] (None: zeros), a chunk of items
        at a time."""
        cfg, params = self.cfg, self.params
        dtype = torch_dtype(cfg.compute_dtype)
        if t_row is None:
            t_row = torch.zeros(cfg.temporal_dim, device=self.device)
        out = []
        for start in range(0, item_mlp.shape[0], _BIAS_CHUNK_ROWS):
            x = item_mlp[start:start + _BIAS_CHUNK_ROWS]
            attn = advanced_ncf._singleton_attention(
                params["attn"], x.to(dtype), dtype)
            t_vec = t_row[None, :].expand(x.shape[0], cfg.temporal_dim)
            combined = torch.cat([attn.to(dtype), t_vec.to(dtype)], dim=-1)
            mlp_vec = mlp_tower(params["mlp"], combined, dtype=dtype)
            out.append(dense(params["mlp_out"], mlp_vec)[:, 0])
        return torch.cat(out)

    def _item_mlp(self) -> torch.Tensor:
        params, cfg = self.params, self.cfg
        return layer_norm(params["mlp_norm"], params["item_emb"][:, cfg.mf_dim:])

    def _mlp_pred_all_items(self, temporal: Optional[Dict[str, int]]) -> torch.Tensor:
        """Eval-mode MLP-path logit for every item, [I] — a pure function
        of (item, temporal context)."""
        cfg, params = self.cfg, self.params
        item_mlp = self._item_mlp()
        if cfg.use_category and self.item_dept is not None and "category" in params:
            item_mlp = item_mlp + advanced_ncf._hierarchy_table(
                params["category"], self.item_dept, self.item_cat,
                0.0, None, True, torch_dtype(cfg.compute_dtype))
        t_row = None
        if cfg.use_temporal and temporal is not None:
            ids = {k: torch.full((1,), int(temporal.get(k, 0)),
                                 dtype=torch.long, device=self.device)
                   for k in ("hour", "day", "month", "day_of_year")}
            t_row = temporal_mod.apply(
                params["temporal"], ids["hour"], ids["day"], ids["month"],
                ids["day_of_year"])[0]
        return self._tower_logit(item_mlp, t_row)

    def _cache_bias(self, key: Tuple, mlp_pred: torch.Tensor) -> torch.Tensor:
        if len(self._bias_cache) >= self._bias_cache_size:
            self._bias_cache.pop(next(iter(self._bias_cache)))
        self._bias_cache[key] = (
            self._wf1 * self._bmf + self._wf2 * mlp_pred + self._bf)
        return self._bias_cache[key]

    @torch.no_grad()
    def item_bias(self, temporal: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """b_i(t) [I], cached per temporal context."""
        key = _context_key(temporal)
        with self._cache_lock:
            if key not in self._bias_cache:
                self._cache_bias(key, self._mlp_pred_all_items(temporal))
            return self._bias_cache[key]

    # ----------------------------------------------------------- queries

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def user_query(self, user_ids) -> torch.Tensor:
        """Query vectors [B, dmf] for registered user ids."""
        return self.user_queries[self._ids(user_ids)]

    # ------------------------------------------------- hourly (demo) path

    @torch.no_grad()
    def _hour_mod(self, hour: int) -> torch.Tensor:
        """The multiplicative hour modulation ``1 + 0.3 * proj(hour_emb)``
        [dmf]; rank-1 over items, so scoring folds it into the query."""
        key = ("hour_mod", hour)
        with self._cache_lock:
            if key not in self._bias_cache:
                p = self.params
                hour_e = p["temporal"]["hour"][hour][None, :]
                self._bias_cache[key] = (
                    1.0 + 0.3 * dense(p["temporal_proj"], hour_e))[0]
            return self._bias_cache[key]

    @torch.no_grad()
    def _hourly_item_bias(self, hour: int) -> torch.Tensor:
        """Per-item bias under ``score_items_with_hour`` semantics: item_mlp
        modulated by the hour vector, t_vec = the raw hour embedding."""
        key = ("hour_bias", hour)
        with self._cache_lock:
            if key in self._bias_cache:
                return self._bias_cache[key]
            item_mlp = self._item_mlp() * self._hour_mod(hour)[None, :]
            mlp_pred = self._tower_logit(
                item_mlp, self.params["temporal"]["hour"][hour])
            return self._cache_bias(key, mlp_pred)

    def topk_for_users_hourly(
        self,
        user_ids,
        hour: int,
        k: int = 10,
        exclude: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k under the demo's hour-of-day scoring: the hour
        folds into the query vector + a cached per-hour item bias."""
        mod = self._hour_mod(hour)
        bias = self._hourly_item_bias(hour)
        return self._retrieve(self._ids(user_ids), mod, ("hour_bias", hour),
                              bias, k, exclude)

    def topk_for_users(
        self,
        user_ids,
        k: int = 10,
        temporal: Optional[Dict[str, int]] = None,
        exclude: Optional[np.ndarray] = None,   # [B, H] item ids or -1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k items per user: (scores sigmoid [B, k], ids [B, k]).

        ``exclude``: optional per-user already-seen items; retrieval
        over-fetches and filters so k results survive."""
        bias = self.item_bias(temporal)
        return self._retrieve(self._ids(user_ids), None,
                              _context_key(temporal), bias, k, exclude)

    @torch.no_grad()
    def _retrieve(self, ids, mod, key, bias, k, exclude):
        """Shared retrieval tail: query gather, prepared-table streaming
        top-k (or the dispatch's plain paths), one host copy, exclusion
        filtering, sigmoid."""
        q = self.user_queries[ids]
        if mod is not None:
            q = q * mod[None, :]
        fetch = k if exclude is None else min(
            self.cfg.num_items, k + exclude.shape[1])
        # fetch > 64 exceeds the streaming kernel's merge: a prepared
        # table would be unfolded per call by the dispatch — the blocked
        # plain path reads the raw table in place instead
        prep = self._prepared(key, bias) if fetch <= 64 else None
        if prep is not None:
            vals, idxs = topk_scores(q, prep, fetch, seg_top=self._seg_top)
        else:
            vals, idxs = topk_scores(q, self.item_vecs, fetch, bias,
                                     impl=self.impl, seg_top=self._seg_top)
        # one device-to-host copy for both: ids ride as f32 bit patterns
        packed = torch.cat(
            [vals.to(torch.float32),
             idxs.to(torch.int32).contiguous().view(torch.float32)],
            dim=1).cpu().numpy()
        n = vals.shape[1]
        vals = packed[:, :n]
        idxs = np.ascontiguousarray(packed[:, n:]).view(np.int32)
        if exclude is not None:
            vals, idxs = _filter_excluded(vals, idxs, exclude, k)
        return _sigmoid(vals), idxs

    @torch.no_grad()
    def score_pairs(self, user_ids, item_ids,
                    temporal: Optional[Dict[str, int]] = None) -> np.ndarray:
        """Probability scores for explicit (user, item) pairs."""
        q = self.user_query(user_ids)
        items = self._ids(item_ids)
        logits = ((q * self.item_vecs[items]).sum(-1)
                  + self.item_bias(temporal)[items])
        return torch.sigmoid(logits).cpu().numpy()


def _filter_excluded(vals: np.ndarray, idxs: np.ndarray,
                     exclude: np.ndarray, k: int):
    """Drop per-row excluded item ids from over-fetched top-k results,
    keeping the first k survivors (host-side; rows already sorted).
    ``exclude``: [B, H] item ids padded with -1."""
    B, fetch = idxs.shape
    kk = min(k, fetch)          # fetch < k when the catalog is small
    hit = (idxs[:, :, None] == exclude[:, None, :]).any(-1)   # [B, fetch]
    order = np.argsort(hit, axis=1, kind="stable")[:, :kk]    # [B, kk]
    keep_v = np.take_along_axis(vals, order, axis=1)
    keep_i = np.take_along_axis(idxs, order, axis=1)
    n_keep = (~hit).sum(axis=1, keepdims=True)                # [B, 1]
    slot = np.arange(kk)[None, :]
    out_v = np.full((B, k), -np.inf, vals.dtype)
    out_i = np.zeros((B, k), np.int32)
    out_v[:, :kk] = np.where(slot < n_keep, keep_v,
                             np.array(-np.inf, vals.dtype))
    out_i[:, :kk] = np.where(slot < n_keep, keep_i, 0)
    return out_v, out_i


def _sigmoid(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, np.float32)
    np.negative(np.abs(x), out)
    np.exp(out, out)
    pos = x >= 0
    out = np.where(pos, 1.0 / (1.0 + out), out / (1.0 + out))
    return np.where(np.isfinite(x), out, 0.0).astype(np.float32)
