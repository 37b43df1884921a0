"""AdvancedNCF — port of ``ncf_tpu/models/advanced_ncf.py``.

Plain functions on tensors over a nested param dict with the JAX pytree's
keys.  The same exact algebra as the reference (see its module
docstring): single-query candidate attention, singleton attention as a
linear map ``Wo(Wv x + bv) + bo``, and the vocabulary-level precompute
when the vocabulary is smaller than the batch's occurrences.

What is ported: ``apply`` in eval and training mode, in both
``candidate_attention`` modes and both vocab branches (the precompute-off
one with the sparse update's injected rows), with the sequence
path (``use_sequence``: the user query attends the user's recent items
through ``sequence_attn``), ``score_candidates``, ``score_items_with_hour``
and the embedding exports.  Training dropout sits where the reference
puts it (``advanced_ncf.py:305-308``): on the attention weights, in the
tower and on the hierarchy vector.  Its masks come from one
``torch.Generator`` (``rng``) drawn in call order; the reference folds a
role index into its key, so the two agree in distribution only.  The
tower routes as the reference's ``_tower`` does, with "on a TPU" read as
"on the card": ``fused_tower`` ``"auto"`` takes the fused kernels (B4,
``ops/tower.py``) for a bf16 CUDA tower that ``tower_fits``.

Under a mesh (``parallel/``) each rank runs ``apply`` on its slice of the
batch.  The table lookups name their table, so that the exchange routes
those of row-sharded tables (``ops/embedding.py::set_exchange``); a
table derived row by row from a shard (the precompute branch's) is a
shard of the same name, and the category hierarchy of an item shard is
built from that shard's rows of ``item_dept``/``item_cat``.  The step
passes ``mesh``: every rank takes the vocabulary branch the whole batch
would, each plain dropout mask is this rank's rows of the mask over the
whole batch (or over the whole item table, for the hierarchy table of a
shard), and the fused tower folds the rank into its dropout seed, as
the reference's does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ncf_tpu_torch.models import temporal as temporal_mod
from ncf_tpu_torch.models.layers import (
    batch_part,
    dense,
    dense_init,
    dropout,
    embedding_init,
    layer_norm,
    layer_norm_init,
    mha_init,
    mlp_tower,
    mlp_tower_init,
)
from ncf_tpu_torch.ops.embedding import embedding_lookup, shard_rows
from ncf_tpu_torch.ops.tower import fused_tower, tower_fits
from ncf_tpu_torch.utils.config import ModelConfig
from ncf_tpu_torch.utils.device import torch_dtype

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Build the parameter dict; tensors live on ``device`` (default: the
    generator's device).  ``device="meta"`` gives a shape-only template."""
    dev = torch.device(device) if device is not None else gen.device
    combined_dim = cfg.mlp_dim + cfg.temporal_dim
    if cfg.use_sequence:
        combined_dim += cfg.mlp_dim
    # MF and MLP tables are stored fused along the feature axis, as in
    # the JAX package
    params: Params = {
        "user_emb": embedding_init(gen, cfg.num_users,
                                   cfg.mf_dim + cfg.mlp_dim, device=dev),
        "item_emb": embedding_init(gen, cfg.num_items,
                                   cfg.mf_dim + cfg.mlp_dim, device=dev),
        "mf_norm": layer_norm_init(cfg.mf_dim, dev),
        "mlp_norm": layer_norm_init(cfg.mlp_dim, dev),
        "attn": mha_init(gen, cfg.mlp_dim, dev),
        "mlp": mlp_tower_init(gen, combined_dim, list(cfg.mlp_hidden_dims),
                              dev),
        "mf_out": dense_init(gen, cfg.mf_dim, 1, dev),
        "mlp_out": dense_init(gen, cfg.mlp_hidden_dims[-1], 1, dev),
        "final": dense_init(gen, 2, 1, dev),
        "temporal": temporal_mod.init(gen, cfg.temporal_dim, dev),
        "temporal_proj": dense_init(gen, cfg.temporal_dim, cfg.mf_dim, dev),
    }
    if cfg.use_sequence:
        params["sequence_attn"] = mha_init(gen, cfg.mlp_dim, dev)
    if cfg.use_category:
        params["category"] = {
            "dept": embedding_init(gen, cfg.num_departments, cfg.mlp_dim,
                                   device=dev),
            "cat": embedding_init(gen, cfg.num_categories, cfg.mlp_dim,
                                  device=dev),
            "attn": mha_init(gen, cfg.mlp_dim, dev),
            "norm": layer_norm_init(cfg.mlp_dim, dev),
        }
    return params


# -------------------------------------------------------------- internals

def _singleton_attention(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """MHA(q, x, x) with a single key == Wo(Wv x + bv) + bo."""
    return dense(p["o"], dense(p["v"], x, dtype), dtype)


def _single_query_attention(
    p: Params,
    user_mlp: torch.Tensor,   # [B, D]
    item_mlp: torch.Tensor,   # [B, S, D]
    num_heads: int,
    dropout_rate: float,
    rng,
    deterministic: bool,
    dtype,
    key_mask: Optional[torch.Tensor] = None,
    part=None,
) -> torch.Tensor:
    """Candidate-slot attention with the repeated-user query computed
    once (Sq=1).  Returns [B, D]."""
    q = dense(p["q"], user_mlp, dtype)
    k = dense(p["k"], item_mlp, dtype)
    v = dense(p["v"], item_mlp, dtype)
    return _sqa_core(p, q, k, v, num_heads, dropout_rate, rng,
                     deterministic, dtype, key_mask, part)


def _sqa_core(
    p: Params,
    q: torch.Tensor,          # [B, D] projected query
    k: torch.Tensor,          # [B, S, D] projected keys
    v: torch.Tensor,          # [B, S, D] projected values
    num_heads: int,
    dropout_rate: float,
    rng,
    deterministic: bool,
    dtype,
    key_mask: Optional[torch.Tensor] = None,
    part=None,
) -> torch.Tensor:
    """Post-projection half of ``_single_query_attention``; ``part`` as
    ``layers.dropout``'s."""
    B, S, D = k.shape
    H = num_heads
    hd = D // H
    scores = (q[:, None, :] * k).reshape(B, S, H, hd).sum(-1) / math.sqrt(hd)
    scores = scores.to(torch.float32)
    if key_mask is not None:                                 # [B, S] bool
        scores = torch.where(key_mask[:, :, None], scores,
                             torch.full_like(scores, -1e9))
    weights = torch.softmax(scores, dim=1)                   # over S
    if key_mask is not None:
        weights = torch.where(key_mask[:, :, None], weights,
                              torch.zeros_like(weights))
    weights = dropout(rng, weights, dropout_rate, deterministic, part)
    pooled = (weights.to(v.dtype)[..., None]
              * v.reshape(B, S, H, hd)).sum(dim=1)           # [B, H, hd]
    out = dense(p["o"], pooled.reshape(B, D), dtype)
    if key_mask is not None:
        out = torch.where(key_mask.any(dim=1)[:, None], out,
                          torch.zeros_like(out))
    return out


def _hierarchy_table(
    p: Params,
    item_dept: torch.Tensor,   # int [num_items]
    item_cat: torch.Tensor,    # int [num_items]
    dropout_rate: float,
    rng,
    deterministic: bool,
    dtype,
    part=None,
) -> torch.Tensor:
    """Per-item category-hierarchy vectors [num_items, D]:
    LN(dropout(Wo Wv dept_e) + cat_e); ``part`` as ``layers.dropout``'s."""
    dept_e = embedding_lookup(p["dept"], item_dept)
    cat_e = embedding_lookup(p["cat"], item_cat)
    fused = _singleton_attention(p["attn"], dept_e.to(dtype), dtype)
    fused = dropout(rng, fused, dropout_rate, deterministic, part)
    return layer_norm(p["norm"], fused.to(torch.float32) + cat_e)


def _use_vocab_precompute(cfg: ModelConfig, batch_rows: int) -> bool:
    """Precompute per-vocabulary tables when the vocabulary is smaller
    than the per-batch occurrence workload."""
    return cfg.num_items + cfg.num_users <= 4 * batch_rows


def _tower(layers, x, cfg: ModelConfig, rng, deterministic: bool, dtype,
           mesh=None):
    """The MLP tower, routed as the reference routes it
    (``advanced_ncf.py:235-262``): ``"auto"`` takes the fused kernels for
    a bf16 tower on the card whose shape ``tower_fits``, else the plain
    layers; ``"on"`` and ``"interpret"`` always take fused semantics (the
    kernels on the card, their plain version on the CPU) and raise where
    the shape does not fit; ``"off"`` takes the plain layers.
    ``remat_tower`` only changes memory, so it needs nothing here.
    ``mesh``: ``x`` is this rank's slice of a batch split over it."""
    mode = getattr(cfg, "fused_tower", "off")
    if mode in ("auto", "on", "interpret"):
        fits = tower_fits(layers, x.shape[-1])
        auto_ok = fits and x.is_cuda and x.dtype == torch.bfloat16
        if mode in ("on", "interpret") or auto_ok:
            if not fits:
                raise ValueError(
                    f"fused_tower={mode!r} but the tower shape does not fit "
                    f"(in_dim={x.shape[-1]})")
            return fused_tower(layers, x, cfg.dropout, rng, deterministic,
                               mesh=mesh)
    return mlp_tower(layers, x, cfg.dropout, rng, deterministic, dtype,
                     batch_part(mesh))


# ---------------------------------------------------------------- forward

def apply(
    params: Params,
    cfg: ModelConfig,
    user_ids: torch.Tensor,               # int [B]
    item_ids: torch.Tensor,               # int [B, S]
    temporal: Optional[Dict[str, torch.Tensor]] = None,  # each int [B]
    item_dept: Optional[torch.Tensor] = None,
    item_cat: Optional[torch.Tensor] = None,
    candidate_attention: bool = True,
    deterministic: bool = True,
    rng=None,
    history: Optional[torch.Tensor] = None,
    user_rows: Optional[torch.Tensor] = None,     # [B, 2d] gathered rows
    item_rows: Optional[torch.Tensor] = None,     # [B, S, 2d]
    history_rows: Optional[torch.Tensor] = None,  # [B, H, 2d]
    mesh=None,
) -> torch.Tensor:
    """Forward pass -> logits [B, S].  Training mode
    (``deterministic=False``) draws its dropout masks from ``rng``, a
    ``torch.Generator`` on the ids' device.  ``history`` (int [B, H],
    padded with -1) is the user's recent items when ``cfg.use_sequence``;
    without it the sequence slot of the tower input is zero.

    ``user_rows``, ``item_rows`` and ``history_rows`` are fused-table rows
    gathered by the caller (the sparse table update of ``train/step.py``):
    they stand in for the lookups of ``user_ids``, ``item_ids`` and
    ``history``, so the gradient flows to them and no ``[V, 2d]`` table
    gradient is formed.  Only the precompute-off regime takes them.

    ``mesh``: the ids are this rank's slice of a batch split over every
    rank of it (module docstring)."""
    B, S = item_ids.shape
    dtype = torch_dtype(cfg.compute_dtype)
    use_cat = (cfg.use_category and item_dept is not None
               and item_cat is not None)
    part = batch_part(mesh)
    vocab = _use_vocab_precompute(cfg, B * S * (part[0] if part else 1))

    dmf = cfg.mf_dim
    if (user_rows is not None or item_rows is not None
            or history_rows is not None):
        # the precompute branch would ignore injected rows
        assert not vocab, (
            "user_rows/item_rows/history_rows require the precompute-OFF "
            "regime (num_items + num_users > 4*B*S)")
    if vocab:
        user_t = torch.cat([
            layer_norm(params["mf_norm"], params["user_emb"][:, :dmf]),
            layer_norm(params["mlp_norm"], params["user_emb"][:, dmf:]),
        ], dim=-1)
        item_mlp_t = layer_norm(params["mlp_norm"],
                                params["item_emb"][:, dmf:])
        if use_cat:
            rows, table_part = shard_rows("item_emb", params["item_emb"]), None
            if rows is not None:           # this rank's rows of the table
                R = rows.stop - rows.start
                table_part = (item_dept.shape[0] // R, rows.start // R)
                item_dept, item_cat = item_dept[rows], item_cat[rows]
            item_mlp_t = item_mlp_t + _hierarchy_table(
                params["category"], item_dept, item_cat,
                cfg.dropout, rng, deterministic, dtype, table_part)
        item_t = torch.cat([
            layer_norm(params["mf_norm"], params["item_emb"][:, :dmf]),
            item_mlp_t,
        ], dim=-1)
        user_t = user_t.to(dtype)
        item_t = item_t.to(dtype)
        user_full = embedding_lookup(user_t, user_ids,
                                     "user_emb")             # [B, 2d]
        item_full = embedding_lookup(item_t, item_ids,
                                     "item_emb")             # [B, S, 2d]
        user_mf, user_mlp = user_full[:, :dmf], user_full[:, dmf:]
        item_mf, item_mlp = item_full[..., :dmf], item_full[..., dmf:]
    else:
        user_full = (user_rows if user_rows is not None
                     else embedding_lookup(params["user_emb"], user_ids,
                                           "user_emb"))
        item_full = (item_rows if item_rows is not None
                     else embedding_lookup(params["item_emb"], item_ids,
                                           "item_emb"))
        user_mf = layer_norm(params["mf_norm"], user_full[:, :dmf])
        user_mlp = layer_norm(params["mlp_norm"], user_full[:, dmf:])
        item_mf = layer_norm(params["mf_norm"], item_full[..., :dmf])
        item_mlp = layer_norm(params["mlp_norm"], item_full[..., dmf:])
        if use_cat:
            ids = item_ids.long()
            hier = _hierarchy_table(
                params["category"], item_dept[ids].reshape(-1),
                item_cat[ids].reshape(-1),
                cfg.dropout, rng, deterministic, dtype, part)
            item_mlp = item_mlp + hier.reshape(B, S, -1)

    # ---- sequence path (``advanced_ncf.py:367-420``)
    seq_vec = None
    if cfg.use_sequence:
        if history is not None:
            hmask = history >= 0
            hsafe = history.clamp(min=0)
            if vocab:
                # K and V are pointwise in the key row: project the item
                # table once into one [V, 2dm] table and gather it once
                sa = params["sequence_attn"]
                item_seq_t = item_t[:, dmf:]
                kv_t = torch.cat([dense(sa["k"], item_seq_t, dtype),
                                  dense(sa["v"], item_seq_t, dtype)],
                                 dim=-1).to(dtype)            # [V, 2dm]
                kv = embedding_lookup(kv_t, hsafe,
                                      "item_emb")            # [B, H, 2dm]
                seq_vec = _sqa_core(
                    sa, dense(sa["q"], user_mlp, dtype), kv[..., :cfg.mlp_dim],
                    kv[..., cfg.mlp_dim:], cfg.num_heads, cfg.dropout, rng,
                    deterministic, dtype, key_mask=hmask, part=part)
            else:
                seq_src = (history_rows if history_rows is not None
                           else embedding_lookup(params["item_emb"], hsafe,
                                                 "item_emb"))
                seq_emb = layer_norm(params["mlp_norm"], seq_src[..., dmf:])
                if use_cat:
                    ids = hsafe.long()
                    seq_hier = _hierarchy_table(
                        params["category"], item_dept[ids].reshape(-1),
                        item_cat[ids].reshape(-1),
                        cfg.dropout, rng, deterministic, dtype, part)
                    seq_emb = seq_emb + seq_hier.reshape(seq_emb.shape)
                seq_vec = _single_query_attention(
                    params["sequence_attn"], user_mlp, seq_emb,
                    cfg.num_heads, cfg.dropout, rng, deterministic, dtype,
                    key_mask=hmask, part=part)               # [B, dm]
        else:
            seq_vec = torch.zeros((B, cfg.mlp_dim), dtype=torch.float32,
                                  device=user_mlp.device)

    # ---- MF path: elementwise product -> Linear(d,1)
    mf_vector = user_mf[:, None, :] * item_mf                # [B, S, dmf]
    mf_pred = dense(params["mf_out"], mf_vector.to(dtype))   # [B, S, 1] f32

    # ---- temporal features
    if cfg.use_temporal and temporal is not None:
        t_vec = temporal_mod.apply(
            params["temporal"], temporal["hour"], temporal["day"],
            temporal["month"], temporal["day_of_year"])      # [B, dt]
    else:
        t_vec = torch.zeros((B, cfg.temporal_dim), dtype=torch.float32,
                            device=user_mf.device)

    # ---- MLP path (attention -> concat temporal -> tower -> Linear(h,1))
    if candidate_attention:
        attn = _single_query_attention(
            params["attn"], user_mlp, item_mlp, cfg.num_heads,
            cfg.dropout, rng, deterministic, dtype, part=part)  # [B, dm]
        parts = [attn.to(dtype)]
        if seq_vec is not None:
            parts.append(seq_vec.to(dtype))
        combined = torch.cat(parts + [t_vec.to(dtype)], dim=-1)
        mlp_vec = _tower(params["mlp"], combined, cfg, rng,
                         deterministic, dtype, mesh)
        mlp_pred = dense(params["mlp_out"], mlp_vec)          # [B, 1]
        mlp_pred = mlp_pred[:, None, :].expand(B, S, 1)
    else:
        attn = _singleton_attention(
            params["attn"], item_mlp.to(dtype), dtype)        # [B, S, dm]
        t_b = t_vec[:, None, :].expand(B, S, cfg.temporal_dim)
        parts = [attn.to(dtype)]
        if seq_vec is not None:
            parts.append(seq_vec[:, None, :].expand(
                B, S, cfg.mlp_dim).to(dtype))
        combined = torch.cat(parts + [t_b.to(dtype)], dim=-1)
        mlp_vec = _tower(params["mlp"], combined, cfg, rng,
                         deterministic, dtype, mesh)
        mlp_pred = dense(params["mlp_out"], mlp_vec)          # [B, S, 1]

    # ---- fusion: Linear(2,1), sigmoid deferred
    both = torch.cat([mf_pred.to(torch.float32),
                      mlp_pred.to(torch.float32)], dim=-1)
    return dense(params["final"], both)[..., 0]


def score_candidates(
    params: Params,
    cfg: ModelConfig,
    user_ids: torch.Tensor,      # [B]
    cand_items: torch.Tensor,    # [B, C]
    temporal: Optional[Dict[str, torch.Tensor]] = None,
    item_dept: Optional[torch.Tensor] = None,
    item_cat: Optional[torch.Tensor] = None,
    history: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Eval/serving scoring: each candidate scored independently.
    Returns logits [B, C]."""
    return apply(params, cfg, user_ids, cand_items, temporal,
                 item_dept, item_cat, candidate_attention=False,
                 deterministic=True, history=history)


def score_items_with_hour(
    params: Params,
    cfg: ModelConfig,
    user_ids: torch.Tensor,      # [B]
    item_ids: torch.Tensor,      # [B]
    hour: Optional[torch.Tensor] = None,  # int [B]
    history: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hour-of-day scoring: product embeddings modulated by
    ``(1 + 0.3 * proj(hour_emb))``.  Returns probabilities [B].  A
    sequence model attends ``history`` (zeros without it)."""
    dtype = torch_dtype(cfg.compute_dtype)
    B = user_ids.shape[0]

    dmf = cfg.mf_dim
    user_full = embedding_lookup(params["user_emb"], user_ids)
    item_full = embedding_lookup(params["item_emb"], item_ids)
    user_mf = layer_norm(params["mf_norm"], user_full[:, :dmf])
    item_mf = layer_norm(params["mf_norm"], item_full[:, :dmf])
    item_mlp = layer_norm(params["mlp_norm"], item_full[:, dmf:])

    if hour is not None:
        hour_e = embedding_lookup(params["temporal"]["hour"], hour)
        mod = 1.0 + 0.3 * dense(params["temporal_proj"], hour_e)
        item_mf = item_mf * mod
        item_mlp = item_mlp * mod

    mf_pred = dense(params["mf_out"], (user_mf * item_mf).to(dtype))
    attn = _singleton_attention(params["attn"], item_mlp.to(dtype), dtype)
    if hour is not None:
        t_vec = embedding_lookup(params["temporal"]["hour"], hour)
    else:
        t_vec = torch.zeros((B, cfg.temporal_dim), dtype=torch.float32,
                            device=user_mf.device)
    parts = [attn.to(dtype)]
    if cfg.use_sequence:
        if history is not None:
            user_mlp = layer_norm(params["mlp_norm"], user_full[:, dmf:])
            seq_emb = layer_norm(
                params["mlp_norm"],
                embedding_lookup(params["item_emb"],
                                 history.clamp(min=0))[..., dmf:])
            seq_vec = _single_query_attention(
                params["sequence_attn"], user_mlp, seq_emb, cfg.num_heads,
                0.0, None, True, dtype, key_mask=history >= 0)
        else:
            seq_vec = torch.zeros((B, cfg.mlp_dim), dtype=torch.float32,
                                  device=user_mf.device)
        parts.append(seq_vec.to(dtype))
    combined = torch.cat(parts + [t_vec.to(dtype)], dim=-1)
    mlp_vec = mlp_tower(params["mlp"], combined, dtype=dtype)
    mlp_pred = dense(params["mlp_out"], mlp_vec)

    both = torch.cat([mf_pred.to(torch.float32),
                      mlp_pred.to(torch.float32)], dim=-1)
    return torch.sigmoid(dense(params["final"], both)[..., 0])


# ----------------------------------------------------------------- export

def get_user_embeddings(params: Params,
                        user_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Normalized user embedding export."""
    dmf = params["mf_norm"]["scale"].shape[0]
    full = embedding_lookup(params["user_emb"], user_ids)
    return {
        "mf": layer_norm(params["mf_norm"], full[:, :dmf]),
        "mlp": layer_norm(params["mlp_norm"], full[:, dmf:]),
    }


def get_product_embeddings(
    params: Params,
    cfg: ModelConfig,
    item_ids: torch.Tensor,
    item_dept: Optional[torch.Tensor] = None,
    item_cat: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Normalized item embedding export, with the category-hierarchy
    vector."""
    dmf = cfg.mf_dim
    full = embedding_lookup(params["item_emb"], item_ids)
    out = {
        "mf": layer_norm(params["mf_norm"], full[:, :dmf]),
        "mlp": layer_norm(params["mlp_norm"], full[:, dmf:]),
    }
    if cfg.use_category and "category" in params and item_dept is not None:
        table = _hierarchy_table(
            params["category"], item_dept, item_cat, 0.0, None, True,
            torch_dtype(cfg.compute_dtype))
        out["category"] = embedding_lookup(table, item_ids)
    return out
