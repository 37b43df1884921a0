"""Item-sharded top-k retrieval: a catalog split over the mesh's ranks.

Port of ``ncf_tpu/parallel/sharded_topk.py``.  Each ici rank holds a
contiguous slice of the catalog and, on every call:

    local:  the port's single-device top-k over its slice: ``topk_scores``
            (the streaming kernel B5 on the card, the exact kernel B8
            under ``impl="pallas"``, B9 under ``"segmented"``), or over a
            once-prepared slice B5 / the int8 kernel B6;
    merge:  an ``all_gather`` over ici of the ``(value, global id)``
            winners, ``[B, E * kk]`` in rank order, and a top-k of those
            whose ties go to the lower position, as ``lax.top_k``'s do
            (``ops/topk.py::_topk_lowest_index``).

Shards hold consecutive ids, so a lower position is a lower id among
equal values, and every answer is the one a single device gives where
the local pass's ties also go to the lower id.  The streaming kernels
surface each segment's best ``seg_top``; a shard's rows are a multiple
of the segment width (``shard_prepare_items*`` pad to ``E *
block_items``; 2M-item shards of the serving catalog are multiples of
128), so shard boundaries are segment boundaries and the sharded answer
is the single-device one.  The card's caps hold per shard: rows of at
most 128 values for B5, B8 and B9, k at most 64 for B5 and B6.

Padded rows carry ``NEG_INF`` bias (f32 tables) or the bias-digit floor
(int8), so they never beat a real candidate; their ids are clamped to
the last real id, as in the reference.  The dcn replicas hold the same
shards and compute the same answer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ncf_tpu_torch.ops.topk import (NEG_INF, PreparedItems, PreparedItemsInt8,
                                    _auto_block_items, _topk_lowest_index,
                                    prepare_items_int8, topk_scores,
                                    topk_scores_streaming,
                                    topk_scores_streaming_int8)
from ncf_tpu_torch.parallel.mesh import ICI_AXIS, Mesh


def shard_items(items: torch.Tensor, bias: Optional[torch.Tensor],
                mesh: Mesh, axis_name: str = ICI_AXIS
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """This rank's slice of the catalog padded to a shard multiple:
    ``(items [I_loc, D], bias f32 [I_loc], num_items)``; padded rows
    carry ``NEG_INF`` bias."""
    I, D = items.shape
    ndev = mesh.shape[axis_name]
    per = -(-I // ndev)
    lo = mesh.ici_index * per
    hi = min(lo + per, I)
    dev = items.device
    t = torch.zeros((per, D), dtype=items.dtype, device=dev)
    b = torch.full((per,), NEG_INF, dtype=torch.float32, device=dev)
    if hi > lo:
        t[:hi - lo] = items[lo:hi]
        b[:hi - lo] = (0.0 if bias is None
                       else bias[lo:hi].to(torch.float32))
    return t, b, I


def _merge(mesh: Mesh, vals: torch.Tensor, ids: torch.Tensor, rows_loc: int,
           num_items: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local winners -> the global top-k: ids made global, clamped to
    the last real id, gathered over ici and merged with ties to the
    lower position."""
    gids = ids.to(torch.int64) + mesh.ici_index * rows_loc
    gids = torch.clamp(gids, max=num_items - 1).to(torch.int32)
    # gathered on dim 0 as [E, B, kk], laid out [B, E * kk] in rank order
    av = mesh.all_gather(vals.contiguous()[None], ICI_AXIS)
    ai = mesh.all_gather(gids.contiguous()[None], ICI_AXIS)
    B = vals.shape[0]
    av = av.permute(1, 0, 2).reshape(B, -1)
    ai = ai.permute(1, 0, 2).reshape(B, -1)
    mv, sel = _topk_lowest_index(av, k)
    return mv, torch.gather(ai, 1, sel.long())


def sharded_topk_scores(
    queries: torch.Tensor,            # [B, D], the same on every rank
    items: torch.Tensor,              # [I_loc, D], this rank's slice
    bias: torch.Tensor,               # [I_loc], NEG_INF padded
    num_items: int,
    mesh: Mesh,
    k: int = 10,
    axis_name: str = ICI_AXIS,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded catalog (build the operands with
    ``shard_items``): ``(values [B, k], global ids [B, k])``, the same on
    every rank.  Every rank of the mesh calls it."""
    del axis_name
    k = min(k, num_items)
    i_loc = items.shape[0]
    kk = min(k, i_loc)
    vals, idxs = topk_scores(queries, items, kk, bias, impl=impl)
    return _merge(mesh, vals, idxs, i_loc, num_items, k)


class ShardedPreparedItems:
    """This rank's once-prepared slice of a row-sharded catalog for
    :func:`sharded_topk_scores_prepared` (the reference's
    ``ShardedPreparedItems``): ``local`` is a valid single-device
    ``PreparedItems`` of ``rows_loc`` rows (a ``block_items`` multiple,
    padded rows with ``NEG_INF`` bias); ``num_items`` is the global
    catalog's size."""

    def __init__(self, local: PreparedItems, num_items: int, dim: int,
                 block_items: int, seg_width: int, user_tile: int):
        self.local = local
        self.num_items = num_items
        self.dim = dim
        self.block_items = block_items
        self.seg_width = seg_width
        self.user_tile = user_tile

    @property
    def rows_loc(self) -> int:
        return self.local.table.shape[0]


class ShardedPreparedItemsInt8(ShardedPreparedItems):
    """This rank's slice of a catalog quantized ONCE for all shards
    (``local`` a ``PreparedItemsInt8`` with the global ``col_scale`` and
    ``q_scale``), so that dequantized scores compare across shards in
    the merge.  The sharded int8 tier has ``int8-fast`` semantics (no
    exact rescore), as in the reference."""


def _chunk(I: int, ndev: int, block_items: int) -> int:
    chunk = ndev * block_items
    return -(-I // chunk) * chunk


def shard_prepare_items(
    items: torch.Tensor,              # [I, D], the whole catalog
    bias: Optional[torch.Tensor],
    mesh: Mesh,
    axis_name: str = ICI_AXIS,
    block_items: Optional[int] = None,
    seg_width: int = 128,
    user_tile: int = 256,
) -> ShardedPreparedItems:
    """Build this rank's streaming operand once: the catalog padded so
    every shard holds a ``block_items`` multiple, padded rows with
    ``NEG_INF`` bias; ``block_items=None`` takes the reference's default
    for ``user_tile``."""
    I, D = items.shape
    if block_items is None:
        block_items = _auto_block_items(D, items.element_size(), user_tile,
                                        seg_width)
    if block_items % seg_width:
        raise ValueError("block_items must be a multiple of seg_width")
    ndev = mesh.shape[axis_name]
    rows_loc = _chunk(I, ndev, block_items) // ndev
    lo = mesh.ici_index * rows_loc
    hi = min(lo + rows_loc, I)
    dev = items.device
    table = torch.zeros((rows_loc, D), dtype=items.dtype, device=dev)
    b = torch.full((rows_loc,), NEG_INF, dtype=torch.float32, device=dev)
    if hi > lo:
        table[:hi - lo] = items[lo:hi]
        b[:hi - lo] = (0.0 if bias is None
                       else bias[lo:hi].to(torch.float32))
    local = PreparedItems(table, b, rows_loc, D, block_items, seg_width,
                          user_tile)
    return ShardedPreparedItems(local, I, D, block_items, seg_width,
                                user_tile)


def shard_prepare_items_int8(
    items: torch.Tensor,              # [I, D], the whole catalog
    bias: Optional[torch.Tensor],
    queries: torch.Tensor,            # [N, D] query sample fixing q_scale
    mesh: Mesh,
    axis_name: str = ICI_AXIS,
    block_items: Optional[int] = None,
    seg_width: int = 128,
    user_tile: int = 256,
) -> ShardedPreparedItemsInt8:
    """Quantize the whole catalog once with the single-device quantizer
    (scales over the real rows only), extend its padding with more
    digit-floor rows to an ``E * block_items`` multiple, and keep this
    rank's slice."""
    I, D = items.shape
    if block_items is None:
        block_items = _auto_block_items(D, 1, user_tile, seg_width)
    if block_items % seg_width:
        raise ValueError("block_items must be a multiple of seg_width")
    ndev = mesh.shape[axis_name]
    base = prepare_items_int8(items, bias, queries, block_items=block_items,
                              seg_width=seg_width, user_tile=user_tile)
    rows_loc = _chunk(I, ndev, block_items) // ndev
    lo = mesh.ici_index * rows_loc
    t = torch.zeros((rows_loc, D + 3), dtype=torch.int8,
                    device=base.table.device)
    t[:, D:] = -127                            # the digit floor
    have = max(0, min(base.table.shape[0] - lo, rows_loc))
    if have:
        t[:have] = base.table[lo:lo + have]
    local = PreparedItemsInt8(t, base.col_scale, base.q_scale, rows_loc, D,
                              block_items, seg_width, user_tile)
    return ShardedPreparedItemsInt8(local, I, D, block_items, seg_width,
                                    user_tile)


def sharded_topk_scores_prepared(
    queries: torch.Tensor,            # [B, D], the same on every rank
    items: ShardedPreparedItems,
    mesh: Mesh,
    k: int = 10,
    axis_name: str = ICI_AXIS,
    seg_top: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a once-prepared sharded catalog: the streaming kernel
    (B5, or B6 for the int8 catalog) on this rank's slice, then the
    merge.  Returns ``(values [B, k], global ids [B, k])``."""
    del axis_name
    k = min(k, items.num_items)
    kk = min(k, items.rows_loc)
    if isinstance(items, ShardedPreparedItemsInt8):
        vals, idxs = topk_scores_streaming_int8(queries, items.local, kk,
                                                seg_top=seg_top)
    else:
        vals, idxs = topk_scores_streaming(queries, items.local, kk,
                                           seg_top=seg_top)
    return _merge(mesh, vals, idxs, items.rows_loc, items.num_items, k)
