"""Exact full-catalog leave-one-out evaluation (``eval_protocol: full``).

Port of ``ncf_tpu/evals/full_eval.py``.  The positive is ranked against
the ENTIRE catalog minus the user's interacted items, exactly:

    rank(u) = #{ i in catalog \\ history(u) : s(u,i) >= s(u,p) }

with the pessimistic tie rule of ``metrics.positive_ranks``: an item that
scores EQUAL to the positive outranks it.

The [U, V] score matrix is never built.  In eval mode the AdvancedNCF
score splits per pair into

    s(u, i, t) = wf0 * (user_mf_u . (item_mf_i * w_mf) + b_mf)
               + wf1 * mlp_out(tower(LN(relu( A1_i + U1_u )))) + b_f

because the attention vector is item-only (singleton attention) and the
sequence and temporal vectors are user-only, so the FIRST tower layer's
pre-activation splits into an item part ``A1_i = attn_i @ W1[:dm]``
(computed per item block from the vocabulary tables) and a user part
``U1_u = concat(seq_u, t_u) @ W1[dm:] + b1`` (computed once per eval
user).  Only the tail of the tower runs per pair, block by block over
(user block x item block).  Its products are plain large matrix products
(``torch.matmul``), as the reference leaves them to XLA; no kernel of the
port runs here.

History exclusion is a separate pass in fixed chunks: every (eval user,
interacted item) pair of the deduplicated full log is scored and its
counts are subtracted from the catalog counts.

``full_ranks_naive`` scores the whole catalog through the model's
``score_candidates`` (B4f on the card under ``fused_tower: auto``): the
parity oracle, and the evaluator for models without the split.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.evals.evaluate import (
    _eval_temporal,
    _tensor,
    metrics_from_ranks,
)
from ncf_tpu_torch.models import advanced_ncf
from ncf_tpu_torch.models import temporal as temporal_mod
from ncf_tpu_torch.models.layers import dense, layer_norm
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device, torch_dtype


def exclusion_pairs(
    full: Interactions, eval_users: np.ndarray,
    eval_items: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicated (local_user_idx, item) pairs covering every item each
    eval user has interacted with.  When ``eval_items`` is given, each
    user's held-out positive is dropped from their pairs: the evaluator
    masks the positive's own catalog column instead, so its score never
    compares against itself (a 1-ulp difference between the blocked and
    the gathered scoring would otherwise move the rank by one)."""
    offsets, items = full.user_histories()      # items sorted per user
    pos = None if eval_items is None else np.asarray(eval_items)
    u_idx = []
    it = []
    for local, u in enumerate(np.asarray(eval_users)):
        row = items[offsets[u]:offsets[u + 1]]
        if len(row) == 0:
            continue
        keep = np.empty(len(row), bool)
        keep[0] = True
        np.not_equal(row[1:], row[:-1], out=keep[1:])   # sorted: dedupe
        row = row[keep]
        if pos is not None:
            row = row[row != pos[local]]
        if len(row) == 0:
            continue
        u_idx.append(np.full(len(row), local, np.int32))
        it.append(row)
    if not u_idx:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    return np.concatenate(u_idx), np.concatenate(it).astype(np.int32)


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    pad = np.full((n - len(x),) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def _matmul(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype``, in f32."""
    return torch.matmul(x.to(dtype).to(torch.float32),
                        w.to(dtype).to(torch.float32))


class FullCatalogEvaluator:
    """Exact full-catalog leave-one-out ranks for AdvancedNCF.

    ``ranks(params)`` returns the 0-based pessimistic rank of each eval
    user's held-out positive within catalog-minus-history.  The users
    (with their temporal context and histories) are stacked ``[nb, Bu]``
    and the exclusion pairs ``[nch, chunk]`` on ``device`` once.
    """

    def __init__(
        self,
        cfg,                        # ModelConfig
        full: Interactions,
        eval_users: np.ndarray,
        eval_items: np.ndarray,
        user_history=None,          # [num_users, H] int32 (-1 pad)
        item_dept=None,
        item_cat=None,
        user_block: int = 512,
        item_block: int = 2048,
        pair_chunk: int = 1 << 16,  # exclusion-pass pairs a chunk
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.U = len(eval_users)
        self.V = cfg.num_items
        Bu = min(int(user_block), max(1, self.U))
        self._C = int(item_block)
        eval_users = np.asarray(eval_users)

        nbu = -(-self.U // Bu)
        users_p = _pad_to(eval_users.astype(np.int32), nbu * Bu, 0)
        pos_p = _pad_to(np.asarray(eval_items, np.int32), nbu * Bu, 0)
        self._users = _tensor(users_p.reshape(nbu, Bu), dev)
        self._pos = _tensor(pos_p.reshape(nbu, Bu), dev)
        temporal = _eval_temporal(full, eval_users)
        self._temporal = {
            k: _tensor(_pad_to(v.astype(np.int32), nbu * Bu, 0).reshape(
                nbu, Bu), dev) for k, v in temporal.items()}
        self._hist = None
        if cfg.use_sequence and user_history is not None:
            h = np.asarray(user_history)[eval_users]
            self._hist = _tensor(_pad_to(h.astype(np.int32), nbu * Bu, -1)
                                 .reshape(nbu, Bu, h.shape[1]), dev)

        # flat exclusion pairs [nch, chunk] and their validity; the
        # positives are dropped (their catalog columns are masked)
        u_idx, ex_items = exclusion_pairs(full, eval_users,
                                          np.asarray(eval_items))
        ch = int(pair_chunk)
        nch = max(1, -(-len(u_idx) // ch))
        valid = _pad_to(np.ones(len(u_idx), bool), nch * ch, False)
        self._ex_u = _tensor(_pad_to(u_idx, nch * ch, 0).reshape(nch, ch),
                             dev)
        self._ex_i = _tensor(_pad_to(ex_items, nch * ch, 0).reshape(nch, ch),
                             dev)
        self._ex_valid = _tensor(valid.reshape(nch, ch), dev)
        self._consts = {k: _tensor(v, dev) for k, v in (
            ("dept", item_dept), ("cat", item_cat)) if v is not None}

    # ------------------------------------------------------------ math

    def _item_tables(self, params, dtype):
        """Per-vocabulary item tables (the vocabulary branch of
        ``advanced_ncf.apply``: LN over the table, the hierarchy folded
        in, cast to the compute dtype), padded to whole item blocks.
        mf_out's weight is not folded in: the model rounds the elementwise
        user x item product to the compute dtype BEFORE the dot with it,
        so the exact replication keeps ``iv`` as the rounded LN rows and
        forms the rounded product per pair (``_pair_scores``)."""
        dmf = self.cfg.mf_dim
        item_mf = layer_norm(params["mf_norm"], params["item_emb"][:, :dmf])
        item_mlp = self._item_mlp(params, dtype)
        iv, imlp = item_mf.to(dtype), item_mlp.to(dtype)
        pad = -(-self.V // self._C) * self._C - self.V
        if pad:          # padding rows are masked out of the counts
            iv = torch.cat([iv, iv.new_zeros((pad, iv.shape[1]))])
            imlp = torch.cat([imlp, imlp.new_zeros((pad, imlp.shape[1]))])
        return iv, imlp

    def _item_mlp(self, params, dtype):
        cfg = self.cfg
        item_mlp = layer_norm(params["mlp_norm"],
                              params["item_emb"][:, cfg.mf_dim:])
        if cfg.use_category and "dept" in self._consts:
            item_mlp = item_mlp + advanced_ncf._hierarchy_table(
                params["category"], self._consts["dept"],
                self._consts["cat"], cfg.dropout, None, True, dtype)
        return item_mlp

    def _item_part(self, params, imlp, dtype):
        """Singleton attention and the first layer's item partial
        ``A1`` (no bias) of item rows ``imlp``: [N, h1] f32."""
        attn = advanced_ncf._singleton_attention(params["attn"], imlp, dtype)
        W1 = params["mlp"][0]["dense"]["w"]
        return _matmul(attn, W1[:self.cfg.mlp_dim], dtype)

    def _user_parts(self, params, users, temporal, hist, kv_t, dtype):
        """Per-user side: the MF vector and the first layer's user partial
        ``U1`` (with the bias)."""
        cfg, dmf, dm = self.cfg, self.cfg.mf_dim, self.cfg.mlp_dim
        u_full = params["user_emb"][users.long()]
        user_mf = layer_norm(params["mf_norm"], u_full[:, :dmf]).to(dtype)
        user_mlp = layer_norm(params["mlp_norm"], u_full[:, dmf:]).to(dtype)
        B = users.shape[0]
        parts = []
        if cfg.use_sequence:
            if hist is not None:
                seq_vec = self._seq_vec(params, user_mlp, hist, kv_t, dtype)
            else:
                seq_vec = torch.zeros((B, dm), device=users.device)
            parts.append(seq_vec.to(dtype))
        if cfg.use_temporal:
            t_vec = temporal_mod.apply(
                params["temporal"], temporal["hour"], temporal["day"],
                temporal["month"], temporal["day_of_year"])
        else:
            t_vec = torch.zeros((B, cfg.temporal_dim), device=users.device)
        parts.append(t_vec.to(dtype))
        W1 = params["mlp"][0]["dense"]
        u1 = dense({"w": W1["w"][dm:], "b": W1["b"]}, torch.cat(parts, -1),
                   dtype)                                     # [B, h1] f32
        return user_mf, u1

    def _tail(self, params, pre1, dtype):
        """The tower after the first layer's pre-activation, then
        mlp_out: [..., h1] f32 -> [...] f32."""
        x = layer_norm(params["mlp"][0]["norm"], torch.relu(pre1))
        for layer in params["mlp"][1:]:
            x = layer_norm(layer["norm"],
                           torch.relu(dense(layer["dense"], x, dtype)))
        return dense(params["mlp_out"], x)[..., 0]

    def _fuse(self, params, prod, mlp_pred):
        """The MF dot of the rounded product with mf_out's f32 weight
        (``apply`` calls ``dense(mf_out, .)`` with no dtype), then the
        final fusion."""
        mf_pred = torch.matmul(prod.to(torch.float32),
                               params["mf_out"]["w"][:, 0])
        mf_pred = mf_pred + params["mf_out"]["b"][0]
        wf = params["final"]["w"][:, 0]
        return wf[0] * mf_pred + wf[1] * mlp_pred + params["final"]["b"][0]

    def _pair_scores(self, params, user_mf, u1, iv_b, a1_b, dtype):
        """Exact logits [B, C] of every (user, block item) pair."""
        mlp_pred = self._tail(params, u1[:, None, :] + a1_b[None, :, :],
                              dtype)
        prod = user_mf[:, None, :] * iv_b[None, :, :]        # rounded
        return self._fuse(params, prod, mlp_pred)

    def _pair_scores_gathered(self, params, iv, imlp, user_mf, u1, items,
                              dtype):
        """The same logits for explicit (user row, item id) pairs [N]: the
        item side gathered by id instead of sliced by block."""
        items = items.long()
        a1 = self._item_part(params, imlp[items], dtype)
        mlp_pred = self._tail(params, u1 + a1, dtype)
        return self._fuse(params, user_mf * iv[items], mlp_pred)

    def _seq_kv_table(self, params, dtype):
        """Projected K/V item table [V, 2*dm] of the sequence path,
        projected once over the vocabulary."""
        sa = params["sequence_attn"]
        item_seq_t = self._item_mlp(params, dtype).to(dtype)
        return torch.cat([dense(sa["k"], item_seq_t, dtype),
                          dense(sa["v"], item_seq_t, dtype)],
                         dim=-1).to(dtype)

    def _seq_vec(self, params, user_mlp, hist, kv_t, dtype):
        """Sequence-attention context per eval user from the K/V table."""
        cfg = self.cfg
        sa = params["sequence_attn"]
        kv = kv_t[hist.clamp(min=0).long()]
        return advanced_ncf._sqa_core(
            sa, dense(sa["q"], user_mlp, dtype), kv[..., :cfg.mlp_dim],
            kv[..., cfg.mlp_dim:], cfg.num_heads, cfg.dropout, None, True,
            dtype, key_mask=hist >= 0)

    # ------------------------------------------------------------- API

    def ranks(self, params) -> np.ndarray:
        """Per-user 0-based pessimistic rank over catalog minus history;
        one copy to the host."""
        cfg, C, V, U = self.cfg, self._C, self.V, self.U
        dtype = torch_dtype(cfg.compute_dtype)
        dev = self.device
        nblk = -(-V // C)
        with torch.no_grad():
            iv, imlp = self._item_tables(params, dtype)
            a1 = [self._item_part(params, imlp[b * C:(b + 1) * C], dtype)
                  for b in range(nblk)]
            kv_t = (self._seq_kv_table(params, dtype)
                    if cfg.use_sequence and self._hist is not None else None)
            g_all, ge_all, s_pos_all, mf_all, u1_all = [], [], [], [], []
            for j in range(self._users.shape[0]):
                u, p = self._users[j], self._pos[j]
                t = {k: v[j] for k, v in self._temporal.items()}
                h = self._hist[j] if self._hist is not None else None
                user_mf, u1 = self._user_parts(params, u, t, h, kv_t, dtype)
                s_pos = self._pair_scores_gathered(params, iv, imlp, user_mf,
                                                   u1, p, dtype)
                g = torch.zeros(u.shape[0], dtype=torch.int32, device=dev)
                ge = torch.zeros_like(g)
                for b in range(nblk):
                    s = self._pair_scores(params, user_mf, u1,
                                          iv[b * C:(b + 1) * C], a1[b], dtype)
                    # mask the catalog's padding columns and each user's
                    # own positive
                    col = b * C + torch.arange(C, device=dev)
                    ok = (col < V)[None, :] & (col[None, :] != p[:, None])
                    g += ((s > s_pos[:, None]) & ok).sum(1, dtype=torch.int32)
                    ge += ((s >= s_pos[:, None]) & ok).sum(
                        1, dtype=torch.int32)
                g_all.append(g)
                ge_all.append(ge)
                s_pos_all.append(s_pos)
                mf_all.append(user_mf)
                u1_all.append(u1)
            g = torch.cat(g_all)[:U]
            ge = torch.cat(ge_all)[:U]
            s_pos = torch.cat(s_pos_all)[:U]
            user_mf_all = torch.cat(mf_all)[:U]
            u1_all = torch.cat(u1_all)[:U]

            # exclusion pass: score every (eval user, history item) pair
            # and subtract its > / >= contributions
            gh = torch.zeros(U, dtype=torch.int32, device=dev)
            geh = torch.zeros_like(gh)
            for uu, ii, ok in zip(self._ex_u, self._ex_i, self._ex_valid):
                uu = uu.long()
                s = self._pair_scores_gathered(
                    params, iv, imlp, user_mf_all[uu], u1_all[uu], ii, dtype)
                sp = s_pos[uu]
                gh.index_add_(0, uu, ((s > sp) & ok).to(torch.int32))
                geh.index_add_(0, uu, ((s >= sp) & ok).to(torch.int32))
            # the pessimistic tie rule over catalog minus history
            out = torch.maximum(g - gh, ge - geh)
        return out.cpu().numpy()

    def __call__(self, params, ks=(1, 5, 10)) -> Dict[str, float]:
        out = metrics_from_ranks(self.ranks(params), ks)
        out["eval_protocol_full"] = 1.0
        return out


def full_ranks_naive(model, params, cfg, full: Interactions,
                     eval_users, eval_items, user_history=None,
                     item_dept=None, item_cat=None, user_block: int = 256,
                     device: DeviceLike = None) -> np.ndarray:
    """Model-agnostic reference: score the WHOLE catalog for each user
    block through ``model.score_candidates`` and rank with the same
    exclusion and tie rules.  O(U x V) forward passes: for small
    vocabularies (NCF/NeuMF) and as the parity oracle of
    ``FullCatalogEvaluator``."""
    dev = resolve_device(device)
    eval_users = np.asarray(eval_users)
    eval_items = np.asarray(eval_items)
    U, V = len(eval_users), cfg.num_items
    temporal = _eval_temporal(full, eval_users)
    u_idx, ex_items = exclusion_pairs(full, eval_users)
    dept = _tensor(item_dept, dev) if item_dept is not None else None
    cat = _tensor(item_cat, dev) if item_cat is not None else None
    hist_t = (np.asarray(user_history)
              if user_history is not None and cfg.use_sequence else None)

    ranks = np.zeros(U, np.int64)
    B = user_block
    for start in range(0, U, B):
        sl = slice(start, min(start + B, U))
        users = eval_users[sl]
        t = {k: _tensor(v[sl], dev) for k, v in temporal.items()}
        kwargs = {}
        if hist_t is not None:
            kwargs["history"] = _tensor(hist_t[users], dev)
        cand = torch.arange(V, dtype=torch.int32, device=dev)[None, :].expand(
            len(users), V).contiguous()
        with torch.no_grad():
            s = model.score_candidates(params, cfg, _tensor(users, dev), cand,
                                       t, dept, cat, **kwargs).cpu().numpy()
        pos = s[np.arange(len(users)), eval_items[sl]]
        g = (s > pos[:, None]).sum(1)
        ge = (s >= pos[:, None]).sum(1)
        # subtract the history's contributions
        m = (u_idx >= start) & (u_idx < sl.stop)
        uu, ii = u_idx[m] - start, ex_items[m]
        sh = s[uu, ii]
        gh = np.zeros(len(users), np.int64)
        geh = np.zeros(len(users), np.int64)
        np.add.at(gh, uu, (sh > pos[uu]))
        np.add.at(geh, uu, (sh >= pos[uu]))
        ranks[sl] = np.maximum(g - gh, ge - geh)
    return ranks
