"""Model-intelligence introspection: attention heads, confidence,
component importance.

Port of ``ncf_tpu/serving/intelligence.py``: normalized score charts,
per-head attention importance (the Q.K^T softmax recomputed, its
standard deviation over the candidates), the attention the sequence path
puts on a user's recent items, prediction-confidence histograms and the
MF-vs-MLP share of the fusion layer's weights.  The attention statistics
run in torch on the params' device through ``models/layers.py`` and
``ops/embedding.py::embedding_lookup`` (the gather kernel B7 under
``set_impl("pallas")``); the histograms and shares are host NumPy.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ncf_tpu_torch.models.layers import dense, layer_norm
from ncf_tpu_torch.ops.embedding import embedding_lookup
from ncf_tpu_torch.utils.config import ModelConfig


def _device_of(params) -> torch.device:
    return params["user_emb"].device


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


@torch.no_grad()
def attention_head_importance(
    params,
    cfg: ModelConfig,
    user_ids,     # [B]
    item_ids,     # [B, S] candidate set per user
) -> np.ndarray:
    """Per-head importance [num_heads]: the standard deviation of each
    head's attention pattern over the candidate axis, averaged over the
    batch; a flat (uninformative) head scores ~0."""
    dev = _device_of(params)
    user_ids, item_ids = _ids(user_ids, dev), _ids(item_ids, dev)
    H = cfg.num_heads
    D = cfg.mlp_dim
    hd = D // H
    dmf = cfg.mf_dim
    user_mlp = layer_norm(
        params["mlp_norm"],
        embedding_lookup(params["user_emb"], user_ids)[:, dmf:])
    item_mlp = layer_norm(
        params["mlp_norm"],
        embedding_lookup(params["item_emb"], item_ids)[..., dmf:])
    p = params["attn"]
    q = dense(p["q"], user_mlp)                     # [B, D]
    k = dense(p["k"], item_mlp)                     # [B, S, D]
    B, S, _ = k.shape
    scores = (q[:, None, :] * k).reshape(B, S, H, hd).sum(-1) / math.sqrt(hd)
    weights = torch.softmax(scores, dim=1)          # [B, S, H]
    return torch.std(weights, dim=1, correction=0).mean(dim=0).cpu().numpy()


@torch.no_grad()
def history_attention_weights(
    params,
    cfg: ModelConfig,
    user_ids,     # [B]
    history,      # [B, H] recent item ids, padded -1
) -> np.ndarray:
    """Head-averaged attention weights [B, H] the sequence path places on
    each of the user's recent items.  Padded slots get exactly 0.
    Requires ``cfg.use_sequence``."""
    if "sequence_attn" not in params:
        raise ValueError("model has no sequence_attn (use_sequence off)")
    dev = _device_of(params)
    user_ids, history = _ids(user_ids, dev), _ids(history, dev)
    NH = cfg.num_heads
    D = cfg.mlp_dim
    hd = D // NH
    dmf = cfg.mf_dim
    mask = history >= 0
    hsafe = history.clamp(min=0)
    user_mlp = layer_norm(
        params["mlp_norm"],
        embedding_lookup(params["user_emb"], user_ids)[:, dmf:])
    seq_emb = layer_norm(
        params["mlp_norm"],
        embedding_lookup(params["item_emb"], hsafe)[..., dmf:])
    p = params["sequence_attn"]
    q = dense(p["q"], user_mlp)                     # [B, D]
    k = dense(p["k"], seq_emb)                      # [B, H, D]
    B, H, _ = k.shape
    scores = (q[:, None, :] * k).reshape(B, H, NH, hd).sum(-1) / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, -1e9)
    weights = torch.softmax(scores, dim=1)          # [B, H, NH]
    weights = torch.where(mask[:, :, None], weights, 0.0)
    return weights.mean(dim=-1).cpu().numpy()       # head-averaged


def confidence_histogram(scores: np.ndarray, bins: int = 10) -> Dict:
    """Prediction-confidence histogram over sigmoid scores."""
    scores = np.asarray(scores).reshape(-1)
    hist, edges = np.histogram(scores, bins=bins, range=(0.0, 1.0))
    return {
        "counts": hist.tolist(),
        "edges": [round(float(e), 3) for e in edges],
        "mean": float(scores.mean()) if len(scores) else 0.0,
        "std": float(scores.std()) if len(scores) else 0.0,
    }


def component_importance(params) -> Dict[str, float]:
    """|weight| share of the MF vs MLP paths in the fusion layer."""
    w = np.abs(params["final"]["w"][:, 0].detach().cpu().numpy())
    total = max(w.sum(), 1e-12)
    return {"mf": float(w[0] / total), "mlp": float(w[1] / total)}


def normalized_scores(scores: np.ndarray) -> np.ndarray:
    """Min-max normalized score chart data."""
    s = np.asarray(scores, np.float64)
    lo, hi = s.min(), s.max()
    if hi - lo < 1e-12:
        return np.full_like(s, 0.5)
    return (s - lo) / (hi - lo)


def intelligence_report(
    params,
    cfg: ModelConfig,
    user_id: int,
    scores: np.ndarray,          # [k] top-k sigmoid scores
    item_ids: np.ndarray,        # [k]
    sample_users: Optional[np.ndarray] = None,
    history: Optional[np.ndarray] = None,   # [H] this user's recent items
) -> Dict:
    """The full dashboard payload for one recommendation set."""
    users = (np.asarray(sample_users)
             if sample_users is not None else np.asarray([user_id]))
    cand = np.tile(np.asarray(item_ids)[None, :], (len(users), 1))
    heads = attention_head_importance(params, cfg, users, cand)
    out = {
        "user_id": int(user_id),
        "normalized_scores": [round(float(v), 4)
                              for v in normalized_scores(scores)],
        "attention_head_importance": [round(float(h), 5) for h in heads],
        "confidence": confidence_histogram(scores),
        "component_importance": component_importance(params),
    }
    if (history is not None and getattr(cfg, "use_sequence", False)
            and "sequence_attn" in params):
        h = np.asarray(history, np.int32).reshape(1, -1)
        w = history_attention_weights(params, cfg, [user_id], h)[0]
        out["history_attention"] = [
            {"item_id": int(i), "weight": round(float(wt), 5)}
            for i, wt in zip(h[0], w) if i >= 0]
    return out
