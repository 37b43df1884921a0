"""Sparse table updates: rowwise Adagrad on the rows a batch touches.

Port of ``ncf_tpu/train/sparse.py`` (fbgemm's fused sparse optimizer).
In the big-vocabulary regime the step gathers the batch's rows outside
the loss and injects them into ``apply`` (``train/step.py``), so autograd
gives one gradient a row occurrence ``[N, d]`` and no ``[V, d]`` buffer
exists; the duplicate occurrences are combined into one total a row,
and rowwise Adagrad updates only those rows and their accumulators.

What the port does where the reference leans on XLA:

- *Order of the sums.*  ``jax.ops.segment_sum`` adds in a fixed order;
  ``index_add_`` on the card adds with atomics in any order.  The combine
  sorts the ids stably and hands that grouping to the scatter kernel B2
  (``ops/scatter.py::scatter_add_grouped``, mode ``f32``), which adds
  each segment's rows in their order without sorting again: the totals
  are the same bits on every run.
- *The sink ids.*  The reference drops the unused slots' out-of-range
  ids in its scatter (``mode="drop"``); a boolean mask would give a
  shape known only on the host.  Here a sink ``num_rows + k`` writes to
  row ``k mod num_rows`` an update of ``-0.0``, and every write is an add
  (``index_add_``): ``x + (-0.0) == x`` for every ``x``, so each row gets
  exactly one non-zero add, however the adds are ordered, and untouched
  rows keep their bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ncf_tpu_torch.ops.scatter import scatter_add_grouped


def combine_duplicate_rows(ids: torch.Tensor, grads: torch.Tensor,
                           num_rows: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rep_ids int64 [N], totals f32 [N, d]): per-unique-id totals of
    ``grads`` [N, d].  Segment k (the k-th smallest distinct id) lands at
    position k with its id in ``rep_ids``; the other positions hold
    distinct out-of-range sinks ``num_rows + k`` and zero totals."""
    ids = ids.reshape(-1)
    n = ids.numel()
    ids_s, order = torch.sort(ids.to(torch.int64), stable=True)
    boundary = torch.ones_like(ids_s)
    boundary[1:] = ids_s[1:] != ids_s[:-1]
    seg_idx = torch.cumsum(boundary, 0) - 1   # the segment of each
    totals = scatter_add_grouped(order, seg_idx, grads.reshape(n, -1), n,
                                 mode="f32")
    rep_ids = torch.arange(n, dtype=torch.int64, device=ids.device) + num_rows
    # every occurrence of a segment writes the same id
    rep_ids.scatter_(0, seg_idx, ids_s)
    return rep_ids, totals


@torch.no_grad()
def sparse_rowwise_adagrad_apply(
    table: torch.Tensor,        # [V, d], updated in place
    acc: torch.Tensor,          # [V] f32 accumulator, updated in place
    rep_ids: torch.Tensor,      # int [N] unique ids; sinks >= V
    totals: torch.Tensor,       # [N, d] f32 per-unique-row totals
    lr,                         # learning rate (scalar or 0-d tensor)
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rowwise Adagrad on pre-combined totals: ``acc += mean(total^2)``,
    ``row -= lr * total / (sqrt(acc) + eps)``.  ``weight_decay`` is
    decay-on-touch: ``weight_decay * row`` joins the total of every
    touched row; idle rows stay as they are."""
    V = table.shape[0]
    valid = rep_ids < V
    rows_at = torch.where(valid, rep_ids, rep_ids % V)
    if weight_decay:
        rows = torch.where(valid[:, None], table[rows_at].to(torch.float32),
                           0.0)
        totals = totals + weight_decay * rows
    g2 = totals.square().mean(dim=1)
    acc_new = torch.where(valid, acc[rows_at], 0.0) + g2
    upd = lr * totals / (acc_new.sqrt() + eps)[:, None]
    neg_zero = torch.tensor(-0.0, dtype=torch.float32, device=table.device)
    table.index_add_(0, rows_at, torch.where(valid[:, None], -upd,
                                             neg_zero).to(table.dtype))
    acc.index_add_(0, rows_at, torch.where(valid, g2, neg_zero))
    return table, acc


def sparse_rowwise_adagrad_update(
    table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
    grads: torch.Tensor, lr, eps: float = 1e-8, weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rowwise-Adagrad step on the rows ``ids`` touch (they may
    repeat): combine the duplicates, then apply."""
    rep_ids, totals = combine_duplicate_rows(ids, grads, table.shape[0])
    return sparse_rowwise_adagrad_apply(table, acc, rep_ids, totals, lr, eps,
                                        weight_decay)
