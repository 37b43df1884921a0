"""Row-sharded embedding tables and the explicit all-to-all exchange.

Port of ``ncf_tpu/parallel/embedding_sharding.py``.  Each rank holds
rows ``[i * R, (i + 1) * R)`` of a table (``i`` its ici index) and looks
up global ids in five steps, as the reference's ``shard_map`` body does:

  1. bucket its ids by owner into a fixed ``[E, C]`` send buffer
     (``_bucket_by_owner``: stable sort, per-owner rank, ``SENTINEL``
     padding, over-capacity ids sent to a dummy slot);
  2. ``all_to_all`` the id buckets over ici;
  3. gather its own rows;
  4. ``all_to_all`` the rows back;
  5. un-permute them into request order (the dummy slot reads zeros).

The backward is the reverse (``_exchange_grad``): each gradient row goes
to its send slot, both buffers are exchanged, and the owner sums what it
received into its shard through the scatter kernel B2
(``ops/scatter.py``, mode ``f32``), in the order of arrival.  Sources
arrive in ici order and each source's rows in its occurrence order, so
with one dcn replica the owner sums every row's occurrences in the
global batch's order, with no atomics.  ``exchange_lookup``'s backward
then sums over the dcn replicas, as the reference's ``psum`` does.

All ranks must call with the same number of ids: the buffers have static
shapes, the ``[E, C]`` of the reference.  ``capacity_factor <= 0`` is
exact capacity (a rank's whole id set fits one owner's bucket, so no id
can overflow however skewed); a positive factor sizes ``C`` by it, and
the ids over capacity read zeros and drop their gradients, as in the
reference (``:57-69``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ncf_tpu_torch.ops.scatter import onehot_scatter_add
from ncf_tpu_torch.parallel.mesh import DCN_AXIS, ICI_AXIS, Mesh

SENTINEL = 2 ** 30


def _bucket_by_owner(ids: torch.Tensor, num_shards: int, rows_per_shard: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ids [n] into a fixed [E, C] send buffer by owner shard.
    Returns (send_ids int32 [E, C], global ids padded with SENTINEL;
    slot int64 [n], each id's flat position in the buffer, ``E * C`` for
    the dummy slot of an id over capacity)."""
    ids = ids.reshape(-1).to(torch.int64)
    n = ids.numel()
    dev = ids.device
    E, C = num_shards, capacity
    owner = torch.div(ids, rows_per_shard, rounding_mode="floor")
    order = torch.sort(owner, stable=True).indices
    sorted_owner = owner[order]
    first = torch.searchsorted(
        sorted_owner, torch.arange(E, dtype=owner.dtype, device=dev))
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    rank_sorted = pos - first[sorted_owner.clamp(0, E - 1)]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    overflow = (rank >= C) | (owner < 0) | (owner >= E)
    slot = torch.where(overflow, torch.full_like(owner, E * C),
                       owner * C + rank)
    send = torch.full((E * C + 1,), SENTINEL, dtype=torch.int32, device=dev)
    send[slot] = ids.to(torch.int32)
    return send[:E * C].reshape(E, C), slot


def capacity_for(local: int, num_shards: int,
                 capacity_factor: float = 0.0) -> int:
    """The bucket capacity ``exchange_lookup`` uses for ``local`` ids a
    rank (the reference's rule)."""
    if capacity_factor and capacity_factor > 0:
        return min(local, max(8, int(np.ceil(local / num_shards
                                             * capacity_factor))))
    return local


def _lookup_fwd(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
                capacity: int):
    """Steps 1-5 on this rank: table [R, D], ids [n] -> [n, D]; also the
    send slots and the received ids, which the backward reuses."""
    E = mesh.shape[ICI_AXIS]
    R, D = table.shape
    my = mesh.ici_index
    send_ids, slot = _bucket_by_owner(ids, E, R, capacity)
    recv_ids = mesh.all_to_all(send_ids, ICI_AXIS).reshape(-1)
    local = recv_ids.to(torch.int64) - my * R
    valid = (recv_ids != SENTINEL) & (local >= 0) & (local < R)
    vecs = table[torch.where(valid, local, 0)]
    vecs = torch.where(valid[:, None], vecs, torch.zeros_like(vecs))
    back = mesh.all_to_all(vecs, ICI_AXIS)
    flat = torch.cat([back, back.new_zeros((1, D))])
    return flat[slot], slot, recv_ids


def _exchange_grad(mesh: Mesh, g: torch.Tensor, slot: torch.Tensor,
                   recv_ids: torch.Tensor, rows_per_shard: int,
                   capacity: int) -> torch.Tensor:
    """The reverse path: g [n, D] -> f32 [R, D], this rank's shard of
    the table gradient from every source of its ici row."""
    E = mesh.shape[ICI_AXIS]
    D = g.shape[-1]
    R = rows_per_shard
    send_g = g.new_zeros((E * capacity + 1, D), dtype=torch.float32)
    # every occurrence has its own slot; over-capacity rows go to the
    # dummy slot and are dropped, as their lookups read zeros
    send_g[slot] = g.to(torch.float32)
    recv_g = mesh.all_to_all(send_g[:E * capacity], ICI_AXIS)
    local = recv_ids.to(torch.int64) - mesh.ici_index * R
    valid = (recv_ids != SENTINEL) & (local >= 0) & (local < R)
    # invalid entries get the out-of-range id R, which B2 drops
    rows = torch.where(valid, local, torch.full_like(local, R))
    return onehot_scatter_add(rows, recv_g, R, mode="f32")


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, capacity, reduce_dcn):
        out, slot, recv_ids = _lookup_fwd(mesh, table, ids, capacity)
        ctx.save_for_backward(slot, recv_ids)
        ctx.mesh, ctx.capacity, ctx.reduce_dcn = mesh, capacity, reduce_dcn
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        slot, recv_ids = ctx.saved_tensors
        grad = _exchange_grad(ctx.mesh, g.reshape(-1, g.shape[-1]), slot,
                              recv_ids, ctx.rows, ctx.capacity)
        if ctx.reduce_dcn:
            # each dcn replica saw a disjoint slice of the batch and holds
            # the same rows: the table's gradient is the dcn sum
            grad = ctx.mesh.all_reduce(grad, DCN_AXIS)
        return grad.to(ctx.dtype), None, None, None, None


def exchange_lookup(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
                    capacity_factor: float = 0.0,
                    reduce_dcn: bool = True) -> torch.Tensor:
    """Differentiable lookup of global ``ids`` (any shape, this rank's
    part of the batch) in this rank's shard ``table`` [N / E, D] of a
    table row-sharded over ici; returns ``[..., D]``.  Every rank of the
    mesh calls it with the same number of ids.  With one ici rank it is
    the plain gather.

    ``reduce_dcn`` (the reference's ``psum`` over dcn in the backward)
    gives the table's gradient; the training step passes False and sums
    each leaf's gradient itself, so that params reached through a table
    derived from the shard are summed over the ranks once."""
    E = mesh.shape[ICI_AXIS]
    if E == 1:
        return table[ids.long()]
    shape = ids.shape
    flat = ids.reshape(-1)
    capacity = capacity_for(flat.numel(), E, capacity_factor)
    out = _Exchange.apply(table, flat, mesh, capacity, reduce_dcn)
    return out.reshape(*shape, table.shape[1])


def exchange_gather(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
                    capacity_factor: float = 0.0) -> torch.Tensor:
    """The forward of ``exchange_lookup`` alone, without autograd (the
    sparse step's row gathers)."""
    with torch.no_grad():
        return exchange_lookup(mesh, table.detach(), ids, capacity_factor)


class ShardedEmbedding:
    """A row-sharded table with the explicit exchange.  ``shard(table)``
    takes this rank's rows of the ``[N, D]`` table; ``lookup(table,
    ids)`` is differentiable, ids being this rank's part of the batch.
    Like the reference's, it works over the ici axis alone (the dcn
    replicas look up the same ids)."""

    def __init__(self, mesh: Mesh, num_rows: int, dim: int,
                 capacity_factor: float = 2.0, axis: str = ICI_AXIS):
        if axis != ICI_AXIS:
            raise ValueError("tables shard over the ici axis")
        self.mesh = mesh
        self.axis = axis
        self.num_shards = int(mesh.shape[axis])
        if num_rows % self.num_shards != 0:
            raise ValueError(
                f"num_rows {num_rows} must divide the {axis}={self.num_shards}"
                f" axis (pad with parallel.pad_rows)")
        self.num_rows = num_rows
        self.dim = dim
        self.rows_per_shard = num_rows // self.num_shards
        self.capacity_factor = capacity_factor

    def shard(self, table: torch.Tensor) -> torch.Tensor:
        i = self.mesh.ici_index
        R = self.rows_per_shard
        return table[i * R:(i + 1) * R].clone()

    def _capacity(self, ids_len_per_shard: int) -> int:
        return max(8, int(np.ceil(ids_len_per_shard / self.num_shards
                                  * self.capacity_factor)))

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """ids [n] (this rank's part) -> [n, D]; the capacity is the
        reference's ``max(8, ceil(n / E * factor))``."""
        cap = self._capacity(ids.numel())
        if self.num_shards == 1:
            return table[ids.long()]
        return _Exchange.apply(table, ids.reshape(-1), self.mesh, cap, False)
