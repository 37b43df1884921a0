"""Batch metrics: accuracy stats and leave-one-out rank metrics.

Port of ``ncf_tpu/evals/metrics.py`` (``accuracy_stats``,
``positive_ranks``, ``rank_metrics``): the same definitions over
``[batch, candidates]`` logit matrices, as tensor code on the scores'
device.  Accuracy thresholds logits at 0 (probability 0.5).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


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
