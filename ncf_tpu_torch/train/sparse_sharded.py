"""Sparse table updates on row-sharded tables.

Port of ``ncf_tpu/train/sparse_sharded.py``: rowwise Adagrad on the rows
a batch touches, with each table's rows split over the mesh's ici ranks.
On every rank:

  1. the per-occurrence row gradients of its slice of the batch
     (``[n_local, d]``: the step injects rows, so no ``[V, d]`` buffer
     exists) are bucketed by owner into fixed ``[E, C]`` buffers
     (``parallel/embedding_sharding.py::_bucket_by_owner``, exact
     capacity) and exchanged with ``all_to_all`` over ici;
  2. an ``all_gather`` over dcn unifies the replicas' occurrences, so
     every rank of an ici column holds the same buffer and the replicas
     stay bit-identical without a dense sum;
  3. the duplicates are combined in the shard's own row space
     (``train/sparse.py::combine_duplicate_rows``, through B2), in the
     order of arrival, which is the global batch's: sources arrive dcn
     then ici, each in its occurrence order.  So the totals are the bits
     the one-rank combine gives;
  4. the clip's squared norm is the sum of the squared totals over ici
     only (the dcn replicas hold the same totals: counted once) plus
     the dense gradients' (``dense_sq``);
  5. rowwise Adagrad applies to the shard and its accumulator.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ncf_tpu_torch.parallel.embedding_sharding import (SENTINEL,
                                                       _bucket_by_owner)
from ncf_tpu_torch.parallel.mesh import DCN_AXIS, ICI_AXIS, Mesh
from ncf_tpu_torch.train.sparse import (combine_duplicate_rows,
                                        sparse_rowwise_adagrad_apply)


def _route_combine(mesh: Mesh, ids: torch.Tensor, g: torch.Tensor,
                   rows_per_shard: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route this rank's per-occurrence gradients to their owners and
    combine them per local row: ids [n_local] global, g [n_local, d] ->
    (rep_ids [m], totals f32 [m, d]), ``m = dcn * E * C``, ids in the
    shard's row space; padding and other shards' entries form a zero
    segment at the out-of-range id ``rows_per_shard``."""
    E = mesh.shape[ICI_AXIS]
    D = g.shape[-1]
    R = rows_per_shard
    send_ids, slot = _bucket_by_owner(ids, E, R, capacity)
    send_g = g.new_zeros((E * capacity + 1, D), dtype=torch.float32)
    send_g[slot] = g.to(torch.float32)
    recv_ids = mesh.all_to_all(send_ids.reshape(-1), ICI_AXIS)
    recv_g = mesh.all_to_all(send_g[:E * capacity], ICI_AXIS)
    if mesh.shape[DCN_AXIS] > 1:
        recv_ids = mesh.all_gather(recv_ids, DCN_AXIS)
        recv_g = mesh.all_gather(recv_g, DCN_AXIS)
    local = recv_ids.to(torch.int64) - mesh.ici_index * R
    valid = (recv_ids != SENTINEL) & (local >= 0) & (local < R)
    local = torch.where(valid, local, torch.full_like(local, R))
    recv_g = torch.where(valid[:, None], recv_g, torch.zeros_like(recv_g))
    return combine_duplicate_rows(local, recv_g, R)


@torch.no_grad()
def sharded_sparse_rowwise_adagrad_update(
    mesh: Mesh,
    tables: Sequence[torch.Tensor],      # this rank's [V_t / E, d] shards
    accs: Sequence[torch.Tensor],        # this rank's [V_t / E] f32
    ids_list: Sequence[torch.Tensor],    # this rank's int [n_t]
    grads_list: Sequence[torch.Tensor],  # this rank's [n_t, d]
    lr,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip: float = 0.0,
    dense_sq=None,                       # sum of squared dense grads
) -> Tuple[list, list, torch.Tensor]:
    """One sharded rowwise-Adagrad step over every table; the shards and
    accumulators are updated in place.  Returns (tables, accs, gscale):
    with ``clip > 0`` the clip factor over every table's totals and
    ``dense_sq`` (the caller scales its dense gradients by it), else 1.
    Every rank of the mesh calls it with the same id counts."""
    reps, tots = [], []
    for t, ids, g in zip(tables, ids_list, grads_list):
        # exact capacity: a rank's whole id set may target one shard (the
        # pipeline sorts users within a batch)
        rep, tot = _route_combine(mesh, ids.reshape(-1),
                                  g.reshape(-1, g.shape[-1]), t.shape[0],
                                  ids.numel())
        reps.append(rep)
        tots.append(tot)
    dev = tables[0].device
    gscale = torch.ones((), dtype=torch.float32, device=dev)
    if clip > 0:
        sq = torch.stack([tot.square().sum() for tot in tots]).sum()
        sq = mesh.all_reduce(sq, ICI_AXIS)
        if dense_sq is not None:
            sq = sq + dense_sq
        gscale = torch.clamp(clip / sq.sqrt(), max=1.0)
        tots = [tot * gscale for tot in tots]
    for t, a, rep, tot in zip(tables, accs, reps, tots):
        sparse_rowwise_adagrad_apply(t, a, rep, tot, lr, eps, weight_decay)
    return list(tables), list(accs), gscale
