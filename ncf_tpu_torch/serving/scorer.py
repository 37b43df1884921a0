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

``SequenceRescoreScorer`` serves ``use_sequence`` models in two stages:
candidates from the decomposition at a population-mean sequence context,
then an exact rescore of them with each user's real history through
``score_candidates`` (whose tower is the fused kernel B4f on the card).

Not ported yet: the ``int8``/``int8-fast`` presets (their kernel is the
TPU's ``topk_scores_streaming_int8``) and ``BruteForceScorer``.
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
        # the sequence-context vector [dm] of the all-items tower input
        # (SequenceRescoreScorer's stage 1); None for other models
        self._seq_ctx: Optional[torch.Tensor] = None
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
            parts = [attn.to(dtype)]
            if self._seq_ctx is not None:
                parts.append(self._seq_ctx[None, :].expand(
                    x.shape[0], cfg.mlp_dim).to(dtype))
            combined = torch.cat(parts + [t_vec.to(dtype)], dim=-1)
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
        vals, idxs = _to_host(vals, idxs)
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


class SequenceRescoreScorer(AdvancedNCFScorer):
    """Two-stage retrieval for ``use_sequence`` AdvancedNCF models.

    The history vector feeds the tower, so the eval MLP logit depends on
    the user and the exact decomposition no longer holds.  Stage 1 takes
    ``fetch`` candidates from the decomposition with the item bias
    evaluated at a population-mean sequence context (the mean over a
    fixed sample of users, drawn at refresh); stage 2 rescores them
    exactly with each user's real history (``score_candidates``), masks
    the excluded items and keeps the top k, so the returned scores are
    true model scores.  ``topk_for_users_hourly`` is stage 1 only.
    """

    def __init__(self, params, cfg: ModelConfig, item_dept=None,
                 item_cat=None, user_history=None, candidates: int = 54,
                 sample_users: int = 8192, **kw):
        self._history_np = (None if user_history is None
                            else np.asarray(user_history, np.int32))
        self.user_history: Optional[torch.Tensor] = None
        self._seq_candidates = candidates
        self._seq_sample = sample_users
        super().__init__(params, cfg, item_dept, item_cat, **kw)

    @torch.no_grad()
    def _mean_seq_context(self, params) -> torch.Tensor:
        cfg = self.cfg
        hist = self.user_history
        if hist is None or "sequence_attn" not in params:
            return torch.zeros(cfg.mlp_dim, device=self.device)
        dtype = torch_dtype(cfg.compute_dtype)
        U = hist.shape[0]
        idx = torch.as_tensor(np.random.default_rng(0).choice(
            U, size=min(self._seq_sample, U), replace=False),
            dtype=torch.long, device=self.device)
        user_mlp = layer_norm(params["mlp_norm"],
                              params["user_emb"][idx][:, cfg.mf_dim:])
        h = hist[idx]
        item_mlp = self._item_mlp()
        if (cfg.use_category and self.item_dept is not None
                and "category" in params):
            item_mlp = item_mlp + advanced_ncf._hierarchy_table(
                params["category"], self.item_dept, self.item_cat,
                0.0, None, True, dtype)
        seq_emb = item_mlp.to(dtype)[h.clamp(min=0).long()]
        seq_vec = advanced_ncf._single_query_attention(
            params["sequence_attn"], user_mlp, seq_emb, cfg.num_heads,
            0.0, None, True, dtype, key_mask=h >= 0)
        return seq_vec.to(torch.float32).mean(dim=0)

    def refresh(self, params) -> None:
        super().refresh(params)
        if self._history_np is not None:
            self.user_history = torch.as_tensor(self._history_np,
                                                device=self.device)
        with self._cache_lock:
            # the caches are empty after super(); biases built from now
            # on see the new context
            self._seq_ctx = self._mean_seq_context(params)

    def _temporal_ids(self, B: int, temporal: Optional[Dict[str, int]]):
        if temporal is None:
            return None
        return {k: torch.full((B,), int(temporal.get(k, 0)),
                              dtype=torch.long, device=self.device)
                for k in ("hour", "day", "month", "day_of_year")}

    def _rescore(self, ids: torch.Tensor, cand: torch.Tensor,
                 temporal: Optional[Dict[str, int]]) -> torch.Tensor:
        """Exact logits [B, C] of candidates ``cand`` with real history."""
        hist = None if self.user_history is None else self.user_history[ids]
        return advanced_ncf.score_candidates(
            self.params, self.cfg, ids, cand,
            self._temporal_ids(ids.shape[0], temporal), self.item_dept,
            self.item_cat, history=hist)

    @torch.no_grad()
    def topk_for_users(
        self,
        user_ids,
        k: int = 10,
        temporal: Optional[Dict[str, int]] = None,
        exclude: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = self._ids(user_ids)
        if exclude is not None:
            # a power-of-two exclusion width, as the reference pads it
            # (-1 never matches a candidate)
            w = max(1, int(exclude.shape[1]))
            wpad = 1 << (w - 1).bit_length()
            if wpad != w:
                exclude = np.concatenate(
                    [exclude, np.full((exclude.shape[0], wpad - w), -1,
                                      exclude.dtype)], axis=1)
        fetch = int(min(self.cfg.num_items, max(
            k + self._seq_candidates,
            k + (exclude.shape[1] if exclude is not None else 0))))
        key = _context_key(temporal)
        bias = self.item_bias(temporal)
        prep = self._prepared(key, bias) if fetch <= 64 else None
        q = self.user_queries[ids]
        if prep is not None:
            _, cand = topk_scores(q, prep, fetch, seg_top=self._seg_top)
        else:
            _, cand = topk_scores(q, self.item_vecs, fetch, bias,
                                  impl=self.impl, seg_top=self._seg_top)
        cand = cand.long()
        logits = self._rescore(ids, cand, temporal)
        if exclude is not None:
            excl = torch.as_tensor(exclude, dtype=torch.long,
                                   device=self.device)
            hit = (cand[:, :, None] == excl[:, None, :]).any(-1)
            logits = torch.where(hit, torch.full_like(logits, -np.inf),
                                 logits)
        vals, sel = torch.topk(logits, min(k, fetch), dim=1)
        vals, idxs = _to_host(vals, torch.gather(cand, 1, sel))
        return _sigmoid(vals), idxs

    @torch.no_grad()
    def score_pairs(self, user_ids, item_ids,
                    temporal: Optional[Dict[str, int]] = None) -> np.ndarray:
        """Exact pair scores, the sequence term included."""
        ids = self._ids(np.atleast_1d(user_ids))
        items = self._ids(np.atleast_1d(item_ids))
        logits = self._rescore(ids, items[:, None], temporal)
        return torch.sigmoid(logits[:, 0]).cpu().numpy()


def _to_host(vals: torch.Tensor, idxs: torch.Tensor):
    """(values f32, ids int32) as NumPy arrays in one device-to-host copy:
    the ids ride as f32 bit patterns."""
    packed = torch.cat(
        [vals.to(torch.float32),
         idxs.to(torch.int32).contiguous().view(torch.float32)],
        dim=1).cpu().numpy()
    n = vals.shape[1]
    return packed[:, :n], np.ascontiguousarray(packed[:, n:]).view(np.int32)


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
