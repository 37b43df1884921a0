"""Temporal encoding: learned hour/day/month embeddings + sinusoidal
day-of-year positional table.

Port of ``ncf_tpu/models/temporal.py``.  Only the plain branch of
``apply`` is ported: the fused lookup-sum kernel (``temporal.py:67-75``,
reached at >= 4096 rows) belongs to the training slice, and serving calls
``apply`` with one row.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ncf_tpu_torch.models.layers import embedding_init
from ncf_tpu_torch.ops.embedding import embedding_lookup

MAX_PERIOD = 365


def init(gen: torch.Generator, embed_dim: int,
         device=None) -> Dict[str, torch.Tensor]:
    return {
        "hour": embedding_init(gen, 24, embed_dim, device=device),
        "day": embedding_init(gen, 7, embed_dim, device=device),
        "month": embedding_init(gen, 12, embed_dim, device=device),
    }


def sinusoidal_table(embed_dim: int, max_period: int = MAX_PERIOD,
                     device=None) -> torch.Tensor:
    """pe[p, 2i] = sin(p * w_i), pe[p, 2i+1] = cos(p * w_i)
    with w_i = exp(-2i * ln(10000)/d)."""
    position = torch.arange(max_period, dtype=torch.float32,
                            device=device)[:, None]
    half = (embed_dim + 1) // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * 2.0 * (-math.log(10000.0) / embed_dim))
    angles = position * div[None, :]
    pe = torch.zeros((max_period, embed_dim), dtype=torch.float32,
                     device=device)
    pe[:, 0::2] = torch.sin(angles)[:, :(embed_dim + 1) // 2]
    pe[:, 1::2] = torch.cos(angles)[:, :embed_dim // 2]
    return pe


def apply(
    params: Dict[str, torch.Tensor],
    hour: torch.Tensor,
    day: torch.Tensor,
    month: torch.Tensor,
    days_since: torch.Tensor,
) -> torch.Tensor:
    """(hour + day + month) learned embeddings + seasonal sinusoid.  All
    index tensors share a leading shape; the result has trailing dim =
    embed_dim."""
    embed_dim = params["hour"].shape[-1]
    pe = sinusoidal_table(embed_dim, device=params["hour"].device)
    temporal = (
        embedding_lookup(params["hour"], hour)
        + embedding_lookup(params["day"], day)
        + embedding_lookup(params["month"], month)
    )
    return temporal + embedding_lookup(pe, days_since % MAX_PERIOD)
