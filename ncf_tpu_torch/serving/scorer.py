"""Top-k scorers: the AdvancedNCF decomposition and the model-agnostic scan.

Port of ``ncf_tpu/serving/scorer.py``.  In eval mode
the AdvancedNCF logit decomposes exactly into a dot product plus a
per-item bias:

    logit(u, i, t) = q_u . v_i + b_i(t)

      q_u    = wf1 * (LN(u_mf) o w_mf)        [user query vector, d_mf]
      v_i    = LN(i_mf)                        [item vector, d_mf]
      b_i(t) = wf1*b_mf + wf2*mlp_pred(i,t) + b_final

so full-model top-k retrieval is a streaming top-k over the item table
(``ops.topk``).  Large catalogs on the card go through the hand-written
streaming kernel against a once-prepared table per bias context: B5 under
the ``exact`` and ``fast`` presets, the int8 kernel B6 under ``int8``
(over-fetch, then an exact rescore) and ``int8-fast`` (dequantized
scores).  ``impl="pallas"`` and ``"segmented"`` take the kernels B8 and B9
on the raw table.

Each request makes one device-to-host copy: the values and the ids come
back together in one ``.cpu()``.

``SequenceRescoreScorer`` serves ``use_sequence`` models in two stages:
candidates from the decomposition at a population-mean sequence context,
then an exact rescore of them with each user's real history through
``score_candidates`` (whose tower is the fused kernel B4f on the card).

``BruteForceScorer`` serves models without the decomposition (NCF,
NeuMF): ``score_candidates`` over item chunks with a running merge.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.convert import tree_leaves
from ncf_tpu_torch.models import advanced_ncf, temporal as temporal_mod
from ncf_tpu_torch.models.layers import dense, layer_norm, mlp_tower
from ncf_tpu_torch.ops.topk import (PreparedItemsInt8, _topk_lowest_index,
                                    prepare_items, prepare_items_int8,
                                    rescore_exact, topk_scores)
from ncf_tpu_torch.utils.config import ModelConfig
from ncf_tpu_torch.utils.device import torch_dtype

# the prepared table only pays when retrieval takes the streaming kernel
# (large catalogs on the card); below this the dense path wins anyway
_PREPARE_MIN_ITEMS = 1 << 16
# ... and only on these devices (the reference: only on a TPU)
_PREPARE_DEVICES = ("cuda",)
# each prepared table is a full catalog copy (1 GB at 4M x 64 f32): cap
# the cache far below the bias cache's 32
_PREPARED_CACHE_SIZE = 4
# item rows per tower pass when building the bias: bounds the [rows, 256]
# activations (4 GB at 4M items in one pass); row-wise ops, same result
_BIAS_CHUNK_ROWS = 1 << 20
# 'int8' preset: extra candidates fetched before the exact rescore
_INT8_OVERFETCH = 6
# (seg_width, seg_top) of each retrieval preset
_PRESETS = {"exact": (128, 2), "fast": (64, 1), "int8": (128, 1),
            "int8-fast": (128, 1)}


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
        'exact' (segments of 128, top 2 each), 'fast' (64, top 1), 'int8'
        (the int8 tier at 128, top 1, over-fetching ``_INT8_OVERFETCH``
        candidates and returning their exact rescored scores) or
        'int8-fast' (the same without the rescore: dequantized scores).
        The int8 tiers quantize against the user-query table's
        per-dimension maxima.  Small catalogs use the exact dense path
        under every preset.  The tables live on the device of
        ``params``."""
        if retrieval not in _PRESETS:
            raise ValueError(f"unknown retrieval preset: {retrieval!r}")
        self._retrieval = retrieval
        self._int8 = retrieval.startswith("int8")
        self._int8_rescore = retrieval == "int8"
        self._seg_width, self._seg_top = _PRESETS[retrieval]
        self.cfg = cfg
        self.impl = impl
        self.item_dept = item_dept
        self.item_cat = item_cat
        self._bias_cache: Dict[Tuple, torch.Tensor] = {}
        self._prepared_cache: Dict[Tuple, object] = {}
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
        # per-dimension |q| bound over the user-query table: fixes the int8
        # tiers' query and bias scale
        self._q_maxabs = self.user_queries.abs().amax(dim=0)
        with self._cache_lock:
            self._bias_cache.clear()
            self._prepared_cache.clear()

    def _prepares(self) -> bool:
        """Whether retrieval takes a prepared table: a large catalog, a
        streaming ``impl``, and the card."""
        return (self.cfg.num_items >= _PREPARE_MIN_ITEMS
                and self.impl in ("auto", "streaming")
                and self.device.type in _PREPARE_DEVICES)

    def _cached(self, key: Tuple, build):
        with self._cache_lock:
            if key not in self._prepared_cache:
                if len(self._prepared_cache) >= _PREPARED_CACHE_SIZE:
                    self._prepared_cache.pop(next(iter(self._prepared_cache)))
                self._prepared_cache[key] = build()
            return self._prepared_cache[key]

    def _prepared(self, key: Tuple, bias: torch.Tensor,
                  q_maxabs: Optional[torch.Tensor] = None):
        """Cached prepared item table for the streaming kernel (one per
        bias context: int8 under the int8 presets, quantized against
        ``q_maxabs`` [D], the bound of that context's queries), or None
        where retrieval takes another path."""
        if not self._prepares():
            return None
        if self._int8:
            qrow = (self._q_maxabs if q_maxabs is None else q_maxabs)[None, :]
            return self._cached(key, lambda: prepare_items_int8(
                self.item_vecs, bias, qrow, seg_width=self._seg_width))
        return self._cached(key, lambda: prepare_items(
            self.item_vecs, bias, seg_width=self._seg_width))

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
                              bias, k, exclude,
                              q_maxabs=self._q_maxabs * mod.abs())

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
    def _retrieve(self, ids, mod, key, bias, k, exclude, q_maxabs=None):
        """Shared retrieval tail: query gather, prepared-table streaming
        top-k (with the int8 tiers' over-fetch and exact rescore) or the
        dispatch's other paths, one host copy, exclusion filtering,
        sigmoid."""
        q = self.user_queries[ids]
        if mod is not None:
            q = q * mod[None, :]
        fetch = k if exclude is None else min(
            self.cfg.num_items, k + exclude.shape[1])
        int8_cap = fetch + (_INT8_OVERFETCH if self._int8_rescore else 0)
        if self._int8 and int8_cap > 64:
            # past the int8 kernel's merge (k <= 64) the dispatch would
            # dequantize the whole table per call; exclusion-heavy requests
            # take the exact bf16-tier routing instead (the reference's):
            # a prepared table at seg 128/2 (B5) while fetch fits the
            # merge, else the blocked exact path on the raw table
            if fetch <= 64 and self._prepares():
                prep = self._cached(("bf16_fallback", key), lambda: (
                    prepare_items(self.item_vecs, bias, seg_width=128)))
                vals, idxs = topk_scores(q, prep, fetch, seg_top=2)
            else:
                vals, idxs = topk_scores(q, self.item_vecs, fetch, bias,
                                         impl=self.impl, seg_top=2)
        else:
            # fetch > 64 exceeds the streaming kernel's merge: a prepared
            # table would be unfolded per call by the dispatch — the
            # blocked plain path reads the raw table in place instead
            prep = (self._prepared(key, bias, q_maxabs) if fetch <= 64
                    else None)
            if prep is not None:
                kern_fetch = fetch
                if self._int8_rescore:
                    # int8 order misplaces near-ties: fetch extra
                    # candidates, rescore exactly, keep the true best
                    kern_fetch = min(fetch + _INT8_OVERFETCH,
                                     self.cfg.num_items)
                vals, idxs = topk_scores(q, prep, kern_fetch,
                                         seg_top=self._seg_top)
                if self._int8_rescore and isinstance(prep, PreparedItemsInt8):
                    vals, idxs = rescore_exact(q, self.item_vecs, bias, idxs)
                    vals, idxs = vals[:, :fetch], idxs[:, :fetch]
            else:
                vals, idxs = topk_scores(q, self.item_vecs, fetch, bias,
                                         impl=self.impl,
                                         seg_top=self._seg_top)
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
        # past the merge (fetch > 64) the dispatch unfolds a prepared
        # table: the raw table serves bf16 presets alike, while the int8
        # tiers keep the reference's dequantized unfold
        prep = (self._prepared(key, bias) if fetch <= 64 or self._int8
                else None)
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


class BruteForceScorer:
    """Model-agnostic top-k: ``score_candidates`` over chunks of
    ``chunk`` items with a running merge (ties to the carry, then to the
    lower id).  Works for any registered model; NCF and NeuMF have no
    dot-product decomposition and serve through it.  Exact."""

    def __init__(self, model, params, cfg: ModelConfig, item_dept=None,
                 item_cat=None, chunk: int = 4096, user_history=None):
        self.model, self.params, self.cfg = model, params, cfg
        self.item_dept, self.item_cat = item_dept, item_cat
        self.chunk = chunk
        self.device = tree_leaves(params)[0].device
        self.user_history = (None if user_history is None else
                             torch.as_tensor(np.asarray(user_history,
                                                        np.int32),
                                             device=self.device))

    def refresh(self, params) -> None:
        """Swap params in place."""
        self.params = params

    @torch.no_grad()
    def _scan_topk(self, user_ids: torch.Tensor, temporal, k: int):
        I = self.cfg.num_items
        C = min(self.chunk, I)
        B = user_ids.shape[0]
        history = (None if self.user_history is None
                   else self.user_history[user_ids])
        vals = torch.full((B, k), -np.inf, device=self.device)
        idxs = torch.zeros((B, k), dtype=torch.int32, device=self.device)
        for start in range(0, I, C):
            cand = (start + torch.arange(C, dtype=torch.int32,
                                         device=self.device))[None, :]
            cand = cand.expand(B, C)
            kwargs = {} if history is None else {"history": history}
            logits = self.model.score_candidates(
                self.params, self.cfg, user_ids, torch.clamp(cand, max=I - 1),
                temporal, self.item_dept, self.item_cat, **kwargs)
            logits = torch.where(cand < I, logits.to(torch.float32),
                                 torch.full_like(logits, -np.inf,
                                                 dtype=torch.float32))
            vals, sel = _topk_lowest_index(torch.cat([vals, logits], 1), k)
            idxs = torch.gather(torch.cat([idxs, cand], 1), 1, sel.long())
        return vals, idxs

    def topk_for_users(self, user_ids, k: int = 10, temporal=None,
                       exclude=None) -> Tuple[np.ndarray, np.ndarray]:
        ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.long,
                              device=self.device)
        t = None
        if temporal is not None:
            t = {key: torch.full((ids.shape[0],), int(temporal.get(key, 0)),
                                 dtype=torch.long, device=self.device)
                 for key in ("hour", "day", "month", "day_of_year")}
        fetch = k if exclude is None else min(
            self.cfg.num_items, k + exclude.shape[1])
        vals, idxs = _to_host(*self._scan_topk(ids, t, fetch))
        vals = _sigmoid(vals)
        if exclude is not None:
            vals, idxs = _filter_excluded(vals, idxs, exclude, k)
        return vals, idxs
