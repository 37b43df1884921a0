"""Batch metrics: leave-one-out rank metrics, the general multi-positive
metrics (HR, NDCG, MRR, MAP at k, AUC) and accuracy stats.

Port of ``ncf_tpu/evals/metrics.py``: the same definitions over
``[batch, candidates]`` logit matrices, as tensor code on the scores'
device.  Accuracy thresholds logits at 0 (probability 0.5).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ncf_tpu_torch.ops.topk import _topk_lowest_index


def positive_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of column 0's score within each row; ties go
    against the positive (a negative with an equal score outranks it)."""
    pos = scores[:, :1]
    greater = (scores[:, 1:] > pos).sum(dim=1)
    equal = (scores[:, 1:] >= pos).sum(dim=1)
    return torch.maximum(greater, equal).to(torch.int32)


def rank_metrics(scores: torch.Tensor,
                 ks: Sequence[int] = (1, 5, 10)) -> Dict[str, torch.Tensor]:
    """hr/ndcg/mrr/map@k and the mean rank from ``[B, 1+negatives]``
    scores with the positive in column 0 (one positive: AP@k == RR@k)."""
    ranks = positive_ranks(scores)
    rf = ranks.to(torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        hit = ranks < k
        zero = torch.zeros_like(rf)
        out[f"hr@{k}"] = hit.to(torch.float32).mean()
        out[f"ndcg@{k}"] = torch.where(hit, 1.0 / torch.log2(rf + 2.0),
                                       zero).mean()
        rr = torch.where(hit, 1.0 / (rf + 1.0), zero)
        out[f"mrr@{k}"] = rr.mean()
        out[f"map@{k}"] = rr.mean()
    out["mean_rank"] = rf.mean()
    return out


def accuracy_stats(logits: torch.Tensor,
                   targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Threshold accuracy and the per-class accuracies."""
    pred = (logits > 0).to(torch.float32)
    t = targets.to(torch.float32)
    correct = (pred == t).to(torch.float32)
    pos_mask, neg_mask = t, 1.0 - t
    return {
        "accuracy": correct.mean(),
        "pos_accuracy": (correct * pos_mask).sum()
        / torch.clamp(pos_mask.sum(), min=1.0),
        "neg_accuracy": (correct * neg_mask).sum()
        / torch.clamp(neg_mask.sum(), min=1.0),
    }


# --------------------------------------------------- general multi-positive

def _topk_relevance(scores: torch.Tensor, targets: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Relevance (0/1) of the top-k scored items per row: [B, k]."""
    # ties to the lower index, as the reference's ``lax.top_k``
    idx = _topk_lowest_index(scores, k)[1].long()
    return torch.take_along_dim(targets, idx, dim=1)


def hit_rate_at_k(scores: torch.Tensor, targets: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Any positive in the top-k."""
    rel = _topk_relevance(scores, targets, k)
    return (rel.sum(dim=1) > 0).to(torch.float32).mean()


def ndcg_at_k(scores: torch.Tensor, targets: torch.Tensor,
              k: int) -> torch.Tensor:
    """Binary-relevance DCG over the ideal DCG."""
    rel = _topk_relevance(scores, targets, k).to(torch.float32)
    discounts = 1.0 / torch.log2(
        torch.arange(k, dtype=torch.float32, device=scores.device) + 2.0)
    dcg = (rel * discounts).sum(dim=1)
    ideal_rel = torch.sort(targets.to(torch.float32), dim=1,
                           descending=True).values[:, :k]
    idcg = (ideal_rel * discounts).sum(dim=1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12),
                       torch.zeros_like(dcg)).mean()


def mrr_at_k(scores: torch.Tensor, targets: torch.Tensor,
             k: int) -> torch.Tensor:
    """1 / rank of the first positive within the top-k."""
    rel = _topk_relevance(scores, targets, k)
    pos_ranks = torch.arange(1, k + 1, dtype=torch.float32,
                             device=scores.device)
    first = torch.argmax((rel > 0).to(torch.int32), dim=1)
    any_hit = rel.sum(dim=1) > 0
    return torch.where(any_hit, 1.0 / pos_ranks[first],
                       torch.zeros_like(pos_ranks[first])).mean()


def map_at_k(scores: torch.Tensor, targets: torch.Tensor,
             k: int) -> torch.Tensor:
    """Mean average precision within the top-k."""
    rel = _topk_relevance(scores, targets, k).to(torch.float32)
    cum = torch.cumsum(rel, dim=1)
    prec = cum / torch.arange(1, k + 1, dtype=torch.float32,
                              device=scores.device)
    num_rel = rel.sum(dim=1)
    ap = torch.where(num_rel > 0,
                     (prec * rel).sum(dim=1) / torch.clamp(num_rel, min=1.0),
                     torch.zeros_like(num_rel))
    return ap.mean()


def auc(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Pairwise AUC over the flattened batch, from the rank-sum identity
    (tied scores take the ranks a stable sort gives them)."""
    s = scores.reshape(-1)
    t = targets.reshape(-1).to(torch.float32)
    order = torch.sort(s, stable=True).indices
    ranks = torch.empty_like(s).scatter_(
        0, order, torch.arange(1, s.shape[0] + 1, dtype=s.dtype,
                               device=s.device))
    n_pos = t.sum()
    n_neg = t.shape[0] - n_pos
    rank_sum = (ranks * t).sum()
    return torch.where(
        (n_pos > 0) & (n_neg > 0),
        (rank_sum - n_pos * (n_pos + 1) / 2)
        / torch.clamp(n_pos * n_neg, min=1.0),
        torch.full_like(n_pos, 0.5))


def calculate_metrics(scores: torch.Tensor, targets: torch.Tensor,
                      ks: Sequence[int] = (1, 5, 10)
                      ) -> Dict[str, torch.Tensor]:
    """General metrics dict over ``[B, C]`` scores and 0/1 targets:
    hit_rate/ndcg/mrr/map at each k (capped at C), AUC and accuracy."""
    out: Dict[str, torch.Tensor] = {}
    C = scores.shape[1]
    for k in ks:
        kk = min(k, C)
        out[f"hit_rate@{k}"] = hit_rate_at_k(scores, targets, kk)
        out[f"ndcg@{k}"] = ndcg_at_k(scores, targets, kk)
        out[f"mrr@{k}"] = mrr_at_k(scores, targets, kk)
        out[f"map@{k}"] = map_at_k(scores, targets, kk)
    out["auc"] = auc(scores, targets)
    out.update(accuracy_stats(scores, targets))
    return out
