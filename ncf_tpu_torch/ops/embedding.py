"""Embedding lookup: a row gather.

Port of the forward of ``ncf_tpu/ops/embedding.py::embedding_lookup``.
The serving path needs the forward only; the backward (the scatter-add
kernel that replaces ``ops/pallas_scatter.py::onehot_scatter_add``) comes
with the training slice.
"""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [N, D], ids int[...]  ->  [..., D]."""
    return table[ids.long()]
