"""Top-k candidate scoring: scores = Q @ T^T (+ bias) -> top-k.

Port of ``ncf_tpu/ops/topk.py``.  Implementations with the reference's
call semantics; each kernel wrapper launches its hand-written kernel on
CUDA tensors and runs its plain PyTorch version (``*_ref``) on CPU
tensors:

- ``topk_scores_streaming`` (B5, ``csrc/topk_streaming.cu``) — the
  retrieval kernel for large catalogs: per-segment top-``seg_top`` then
  a top-k merge, never materialising the [B, I] score matrix.
- ``topk_scores_streaming_int8`` (B6, ``csrc/topk_streaming_int8.cu``) —
  the same over an int8-quantized catalog (``prepare_items_int8``):
  int8 x int8 -> int32 scores with the bias as three digit columns,
  bit-identical to the reference.
- ``topk_scores_pallas`` (B8, ``csrc/topk_exact.cu``) — exact top-k,
  ties to the lower id, k <= 256.
- ``topk_scores_segmented`` (B9, ``csrc/topk_segmax.cu`` for its
  per-segment keys) — one quantized candidate per segment, then an exact
  rescore.
- ``topk_scores_dense`` — one matmul + a top-k (small catalogs).
- ``topk_scores_xla``   — the blocked exact path with a running merge
  (name kept from the reference, where XLA ran it).
- ``rescore_exact``     — exact re-score + re-sort of candidates.

B5, B8 and B9 score on the tensor cores (``csrc/topk_common.cuh``:
split-TF32 ``mma.sync`` for f32 tables, bf16 for bf16, the table streamed
through a ``cp.async`` ring) and take rows of at most 128 values
(``ValueError`` above, on CUDA tensors).

Ties: the reference's ``lax.top_k`` breaks ties to the lower index and
``torch.topk`` promises nothing, so the plain paths sort stably.  The
streaming functions order equal values as the reference's running merge
``[carry; m1 of every segment; m2 of every segment]`` does: by item block
(``block_items`` items), then segment maxima before runners-up, then by
segment.  Slots beyond the candidates come back as ``NEG_INF`` with the
reference's id there: the best candidate of the blocks before the last
(the carry's top-1 entering the last block), or 0 with one block.  The
int8 tier also reports winners at or below ``_PAD_FLOOR`` as ``NEG_INF``
(with their own, clamped, id).

The TPU-only operand tricks do not carry over: ``PreparedItems`` keeps
the bias as an f32 vector added in the kernel's epilogue (the TPU folded
it into three bf16 matmul columns; the int8 tier keeps its three integer
digit columns, which are part of its arithmetic).  ``block_items`` is
sized by the reference's own rule (``_auto_block_items``) because it
decides those tie and empty-slot ids; the CUDA kernels pick their own
tiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ncf_tpu_torch.ops import _kernels

NEG_INF = -3.0e38
_MAX_STREAM_K = 64     # the merge keeps at most 64 winners per user
_MAX_TC_DIM = 128      # widest row the tensor-core tile stages (B5, B8, B9)
_MAX_SCRATCH_BYTES = 1 << 30
_STREAM_VMEM_BUDGET = 12 * 1024 * 1024   # the reference's block sizing


def _auto_block_items(d: int, item_bytes: int, tu: int,
                      seg_width: int) -> int:
    """The reference's default item block (``topk.py:340``): the largest
    power of two (a multiple of ``seg_width``, at most 8192) whose TPU
    working set fits its scoped-VMEM budget.  Kept because the block
    decides the tie order and the empty-slot id."""
    lanes = -(-(d + 3) // 128) * 128
    ti = 8192
    while ti > seg_width:
        if ti * tu * 4 + ti * lanes * item_bytes * 2 <= _STREAM_VMEM_BUDGET:
            break
        ti //= 2
    return max(ti, seg_width)


def _user_tile(B: int, user_tile: int) -> int:
    return min(user_tile, max(8, -(-B // 8) * 8))


def _topk_lowest_index(scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``
    semantics); ids int32."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _scores(queries: torch.Tensor, items: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, I] f32 scores: products of the operands as given, summed in
    f32 (``dot_general(..., preferred_element_type=f32)``)."""
    s = torch.matmul(queries.to(torch.float32), items.to(torch.float32).T)
    if bias is not None:
        s = s + bias[None, :].to(torch.float32)
    return s


# ------------------------------------------------------------ plain paths

def topk_scores_dense(
    queries: torch.Tensor,            # [B, D]
    items: torch.Tensor,              # [I, D]
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot exact top-k: materialize [B, I] scores."""
    return _topk_lowest_index(_scores(queries, items, bias),
                              min(k, items.shape[0]))


def topk_scores_xla(
    queries: torch.Tensor,            # [B, D]
    items: torch.Tensor,              # [I, D]
    k: int = 10,
    bias: Optional[torch.Tensor] = None,   # [I]
    block_items: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked exact top-k with a running merge: (values [B, k],
    indices [B, k]).  The carry comes first in each merge, so ties keep
    the lower id, as in the reference."""
    B = queries.shape[0]
    I = items.shape[0]
    dev = queries.device
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    idxs = torch.zeros((B, k), dtype=torch.int32, device=dev)
    for start in range(0, I, block_items):
        stop = min(start + block_items, I)
        blk = _scores(queries, items[start:stop],
                      None if bias is None else bias[start:stop])
        if stop - start < block_items:    # padded rows score NEG_INF
            blk = torch.cat([blk, torch.full(
                (B, block_items - (stop - start)), NEG_INF,
                dtype=torch.float32, device=dev)], dim=1)
        bv, bi = _topk_lowest_index(blk, k)
        cat_v = torch.cat([vals, bv], dim=1)
        cat_i = torch.cat([idxs, bi + start], dim=1)
        vals, sel = _topk_lowest_index(cat_v, k)
        idxs = torch.gather(cat_i, 1, sel.long())
    return vals, idxs


def rescore_exact(
    queries: torch.Tensor,            # [B, D] float
    items: torch.Tensor,              # [I, D] float
    bias: Optional[torch.Tensor],     # [I] or None
    idxs: torch.Tensor,               # [B, k] candidate ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-score + stable re-sort of retrieved candidates."""
    ids = idxs.long()
    win = items[ids].to(torch.float32)                       # [B, k, D]
    vals = torch.einsum("bd,bkd->bk", queries.to(torch.float32), win)
    if bias is not None:
        vals = vals + bias.to(torch.float32)[ids]
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, torch.gather(idxs, 1, order)


# ---------------------------------------------------------- prepared table

class PreparedItems:
    """The streaming kernel's item operand, built once per (params, bias
    context): the table padded to a ``block_items`` multiple and the
    bias as an f32 vector with ``NEG_INF`` on padded rows (the kernel
    adds it in its epilogue).  Construct via :func:`prepare_items`."""

    def __init__(self, table: torch.Tensor, bias: torch.Tensor,
                 num_items: int, dim: int, block_items: int,
                 seg_width: int, user_tile: int = 256):
        self.table = table            # [Ipad, dim]
        self.bias = bias              # [Ipad] f32
        self.num_items = num_items
        self.dim = dim
        self.block_items = block_items
        self.seg_width = seg_width
        self.user_tile = user_tile    # sizes the default block only

    def unfold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(items [I, D], bias [I])`` exactly as prepared."""
        return self.table[:self.num_items], self.bias[:self.num_items]


def prepare_items(
    items: torch.Tensor,              # [I, D]
    bias: Optional[torch.Tensor] = None,   # [I]
    block_items: Optional[int] = None,
    seg_width: int = 128,
    user_tile: int = 256,
) -> PreparedItems:
    """Build the streaming kernel's item operand once.  Pass the result
    as ``items`` to ``topk_scores_streaming``/``topk_scores`` with
    ``bias=None``.  ``block_items=None`` takes the reference's default
    block for ``user_tile``."""
    I, D = items.shape
    if block_items is None:
        block_items = _auto_block_items(D, items.element_size(), user_tile,
                                        seg_width)
    if block_items % seg_width:
        raise ValueError("block_items must be a multiple of seg_width")
    ipad = -(-I // block_items) * block_items
    table = torch.zeros((ipad, D), dtype=items.dtype, device=items.device)
    table[:I] = items
    b = torch.full((ipad,), NEG_INF, dtype=torch.float32, device=items.device)
    b[:I] = 0.0 if bias is None else bias.to(torch.float32)
    return PreparedItems(table, b, I, D, block_items, seg_width, user_tile)


# --------------------------------------------------- streaming top-k

def _streaming_operands(queries, items, bias, block_items, user_tile,
                        seg_width, seg_top):
    """Validate like the reference and normalise to (q, table, bias or
    None, num_items, seg_width, block_items): ``q`` cast to the table's
    dtype, as the reference casts the queries to the item operand's."""
    if seg_top not in (1, 2):
        raise ValueError("seg_top must be 1 or 2")
    if isinstance(items, PreparedItems):
        if bias is not None:
            raise ValueError(
                "bias must be None with PreparedItems (it is baked in)")
        if block_items is not None and block_items != items.block_items:
            raise ValueError("block_items fixed at prepare_items time")
        if seg_width is not None and seg_width != items.seg_width:
            raise ValueError("seg_width fixed at prepare_items time")
        table, bias, num_items = items.table, items.bias, items.num_items
        seg_width, block_items = items.seg_width, items.block_items
    else:
        if seg_width is None:
            seg_width = 128
        table, num_items = items, items.shape[0]
        if block_items is None:
            block_items = _auto_block_items(
                table.shape[1], table.element_size(),
                _user_tile(queries.shape[0], user_tile), seg_width)
        if block_items % seg_width:
            raise ValueError("block_items must be a multiple of seg_width")
    if seg_width <= 0 or seg_width & (seg_width - 1):
        raise ValueError("seg_width must be a power of two")
    return (queries.to(table.dtype), table, bias, num_items, seg_width,
            block_items)


def _segment_candidates(scores, row0, seg_width, seg_top, block_items):
    """Per-segment top-``seg_top`` of a [B, C] score chunk whose columns
    are global rows ``row0 ..`` (C a multiple of ``block_items``): first
    maximum, then the best of the rest with the first hit masked (the
    reference's order).  Returned in the reference's merge order: item
    block, then all segment maxima before all runners-up, then segment."""
    B, C = scores.shape
    nseg = block_items // seg_width
    s3 = scores.reshape(B, C // seg_width, seg_width)
    off = torch.arange(seg_width, device=scores.device)[None, None, :]
    base = (row0 + torch.arange(C // seg_width, device=scores.device)
            * seg_width)[None, :]
    m1 = s3.max(dim=2).values
    off1 = torch.where(s3 == m1[..., None], off, seg_width).min(dim=2).values
    vals, ids = [m1], [base + off1]
    if seg_top == 2:
        s3b = torch.where(off == off1[..., None],
                          torch.full_like(s3, NEG_INF), s3)
        m2 = s3b.max(dim=2).values
        off2 = torch.where(s3b == m2[..., None], off,
                           seg_width).min(dim=2).values
        vals.append(m2)
        ids.append(base + torch.clamp(off2, max=seg_width - 1))
    return _merge_order(vals, nseg), _merge_order(ids, nseg)


def _merge_order(parts, nseg):
    """Per-rank [B, segments] candidates -> [B, blocks * seg_top * nseg]
    in the reference's merge order: item block, then rank, then segment."""
    B = parts[0].shape[0]
    t = torch.stack([x.reshape(B, -1, nseg) for x in parts], dim=2)
    return t.reshape(B, -1)


def _merge_candidates(cand_v, cand_i, k, early, floor):
    """Top-k of candidates in merge order (a stable sort keeps that order
    among equal values).  Slots beyond the candidates and winners at or
    below ``floor`` are empty: they keep ``floor`` and take the reference's
    id, the best of the first ``early`` candidates (the carry's top-1
    entering the last block) where it beats ``floor``, else 0.  Returns
    (values, ids, empty mask)."""
    B = cand_v.shape[0]
    vals, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    ids = torch.gather(cand_i, 1, order[:, :k])
    if vals.shape[1] < k:                 # fewer candidates than k
        pad = k - vals.shape[1]
        vals = torch.cat([vals, torch.full((B, pad), floor, dtype=vals.dtype,
                                           device=vals.device)], dim=1)
        ids = torch.cat([ids, torch.zeros((B, pad), dtype=ids.dtype,
                                          device=ids.device)], dim=1)
    fill = torch.zeros((B,), dtype=ids.dtype, device=ids.device)
    if early > 0:
        ev = cand_v[:, :early]
        top = torch.argmax((ev == ev.max(dim=1, keepdim=True).values).to(
            torch.int8), dim=1, keepdim=True)     # first of the best
        best_v = torch.gather(ev, 1, top)[:, 0]
        fill = torch.where(best_v > floor,
                           torch.gather(cand_i[:, :early], 1, top)[:, 0], fill)
    empty = vals <= floor
    ids = torch.where(empty, fill[:, None].expand_as(ids), ids)
    return vals, ids, empty


def _streaming_ref_core(q, table, bias, num_items, k, seg_width, seg_top,
                        block_items, chunk_elems: int = 1 << 28):
    B = q.shape[0]
    n_rows = table.shape[0]
    nblocks = -(-n_rows // block_items)
    padded = nblocks * block_items
    chunk = max(block_items,
                (chunk_elems // max(B, 1)) // block_items * block_items)
    cand_v, cand_i = [], []
    for row0 in range(0, padded, chunk):
        stop = min(row0 + chunk, padded)
        real = min(stop, n_rows)
        s = _scores(q, table[row0:real],
                    None if bias is None else bias[row0:real])
        if real < stop:                   # rows past the table never surface
            s = torch.cat([s, torch.full((B, stop - real), NEG_INF,
                                         dtype=torch.float32,
                                         device=q.device)], dim=1)
        v, i = _segment_candidates(s, row0, seg_width, seg_top, block_items)
        cand_v.append(v)
        cand_i.append(i)
    early = (nblocks - 1) * (block_items // seg_width) * seg_top
    vals, ids, empty = _merge_candidates(torch.cat(cand_v, dim=1),
                                         torch.cat(cand_i, dim=1), k, early,
                                         NEG_INF)
    vals = torch.where(empty, torch.full_like(vals, NEG_INF), vals)
    return vals, torch.clamp(ids, max=num_items - 1).to(torch.int32)


def topk_scores_streaming_ref(
    queries: torch.Tensor,            # [B, D]
    items,                            # [I, D] tensor or PreparedItems
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    block_items: Optional[int] = None,
    user_tile: int = 256,
    seg_width: Optional[int] = None,
    seg_top: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``topk_scores_streaming`` (same
    arguments, same result).  Scores [B, I] are formed a chunk of items
    at a time, so it runs at serving sizes on the card too."""
    q, table, b, num_items, seg_width, block_items = _streaming_operands(
        queries, items, bias, block_items, user_tile, seg_width, seg_top)
    return _streaming_ref_core(q, table, b, num_items, min(k, num_items),
                               seg_width, seg_top, block_items)


def _streaming_cuda(q, table, bias, num_items, k, seg_width, seg_top,
                    block_items):
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"streaming kernel takes f32/bf16, got {table.dtype}")
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(
            f"shape mismatch: queries {tuple(q.shape)}, "
            f"table {tuple(table.shape)}")
    if not 1 <= k <= _MAX_STREAM_K:
        raise ValueError(f"streaming kernel takes 1 <= k <= 64, got {k}")
    if seg_width not in (32, 64, 128):
        raise ValueError(f"streaming kernel takes seg_width 32/64/128, "
                         f"got {seg_width}")
    if q.shape[1] > _MAX_TC_DIM:
        raise ValueError(f"streaming kernel takes dim <= {_MAX_TC_DIM}, "
                         f"got {q.shape[1]}")
    dev = table.device
    if q.device != dev or (bias is not None and bias.device != dev):
        raise ValueError("queries, table and bias must share one device")
    q = q.contiguous()
    table = table.contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    B, D = q.shape
    n_rows = table.shape[0]
    nblocks = -(-n_rows // block_items)
    if nblocks * block_items * seg_top >= 1 << 32:
        raise ValueError("too many items for the kernel's 32-bit tie keys")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    ncand = -(-n_rows // seg_width) * seg_top
    # users per launch: bounds the candidate-key scratch (8 bytes per
    # candidate) for very large batches
    rows = max(1, min(B, _MAX_SCRATCH_BYTES // (ncand * 8)))
    keys = torch.empty((rows, ncand), dtype=torch.int64, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    dtype_code = 0 if table.dtype == torch.float32 else 1
    with torch.cuda.device(dev):
        for start in range(0, B, rows):
            n = min(rows, B - start)
            _kernels.launch(
                *C_ENTRY, q[start].data_ptr(), table.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                dtype_code, n, D, n_rows, num_items, seg_width, seg_top,
                block_items // seg_width, nblocks, k, keys.data_ptr(),
                vals[start].data_ptr(), ids[start].data_ptr(),
                _kernels.stream_of(table))
            topk_scores_streaming.launches.add()
    return vals, ids


def topk_scores_streaming(
    queries: torch.Tensor,            # [B, D]
    items,                            # [I, D] tensor or PreparedItems
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    block_items: Optional[int] = None,
    user_tile: int = 256,
    seg_width: Optional[int] = None,   # None: prepared value, else 128
    seg_top: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-streaming top-k (the reference's
    ``ncf_tpu.ops.topk.topk_scores_streaming``): each ``seg_width``
    segment of consecutive item ids surfaces its best ``seg_top``, and
    the result is the top-k of those, with exact f32 scores and ids.
    An item is missed only when more than ``seg_top`` of the true top-k
    share its segment.  Equal values and slots beyond the candidates
    follow the reference's merge (see the module docstring).

    CUDA tensors launch the kernel (``csrc/topk_streaming.cu``) or
    raise; CPU tensors run ``topk_scores_streaming_ref``.  Each kernel
    launch adds one to ``topk_scores_streaming.launches``."""
    q, table, b, num_items, seg_width, block_items = _streaming_operands(
        queries, items, bias, block_items, user_tile, seg_width, seg_top)
    k = min(k, num_items)
    if table.device.type == "cpu":
        return _streaming_ref_core(q, table, b, num_items, k, seg_width,
                                   seg_top, block_items)
    if table.device.type != "cuda":
        raise RuntimeError(f"no streaming kernel for {table.device}")
    return _streaming_cuda(q, table, b, num_items, k, seg_width, seg_top,
                           block_items)


topk_scores_streaming.launches = _kernels.LaunchCounter()
# (library, C function, argument codes of ``_kernels.bind``)
C_ENTRY = ("topk_streaming", "ncf_topk_streaming", "ppp" + "i" * 10 + "pppp")


# ------------------------------------------------- int8 streaming tier

# int32 "minus infinity" of the second-winner mask: far below any
# reachable accumulator (|acc| <= D*127^2 + 32385 < 2^24 at D <= 1024)
_INT_NEG = -(2 ** 30)
# bias digit range with query-side weights (127, 127, 1): see
# _bias_digits — |B_int| <= 127*254 + 64
_BIAS_INT_LIM = 32322.0
# accumulator of a padded row: zero vector + every digit at -127
# (127*-127 + 127*-127 + -127); winners at or below it report as empty
_PAD_FLOOR = -32385.0
_INT8_WEIGHTS = (127.0, 127.0, 1.0)   # query-side weights of the digits
_INV127 = float(np.float32(1.0) / np.float32(127.0))


class PreparedItemsInt8:
    """The int8-quantized item operand of
    :func:`topk_scores_streaming_int8`, built once per (params, bias
    context) by :func:`prepare_items_int8`, in the reference's layout:

    - ``table`` int8 [Ipad, D + 3]: ``round(v[:, d] / col_scale[d])`` and
      three bias digit columns with query-side weights (127, 127, 1)
      encoding ``round(bias / q_scale)`` clipped to +-32322; padded rows
      are a zero vector with every digit at -127 (score ``_PAD_FLOOR``);
    - ``col_scale`` f32 [D]: per-dimension ``max |v| / 127``;
    - ``q_scale`` f32 []: ``max |q o col_scale| / 127`` over the query
      sample given at prepare time, so every call quantizes its queries
      against a fixed scale.

    The dequantized score is ``acc * q_scale``."""

    def __init__(self, table: torch.Tensor, col_scale: torch.Tensor,
                 q_scale: torch.Tensor, num_items: int, dim: int,
                 block_items: int, seg_width: int, user_tile: int = 256):
        self.table = table            # [Ipad, dim + 3] int8
        self.col_scale = col_scale    # [dim] f32
        self.q_scale = q_scale        # [] f32
        self.num_items = num_items
        self.dim = dim
        self.block_items = block_items
        self.seg_width = seg_width
        self.user_tile = user_tile    # sizes the default block only

    def unfold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dequantized ``(items [I, D] f32, bias [I] f32)``: approximate
        (item rounding error <= col_scale / 2 per entry)."""
        t = self.table[:self.num_items].to(torch.float32)
        d = self.dim
        items = t[:, :d] * self.col_scale[None, :]
        bias = (127.0 * t[:, d] + 127.0 * t[:, d + 1] + t[:, d + 2]
                ) * self.q_scale
        return items, bias


def _bias_digits(b_int: torch.Tensor) -> torch.Tensor:
    """Integer bias values (f32-held, clipped to +-32322) -> three int8
    digits [I, 3] with 127*d1 + 127*d2 + d3 == b_int exactly: hi =
    round(b/127) split across two +-127 digits, the residual (|.| <= 64)
    on the weight-1 column."""
    hi = torch.clamp(torch.round(b_int * _INV127), -254.0, 254.0)
    d3 = b_int - 127.0 * hi
    d1 = torch.ceil(hi / 2.0)
    d2 = hi - d1
    return torch.stack([d1, d2, d3], dim=1)


def prepare_items_int8(
    items: torch.Tensor,              # [I, D] float
    bias: Optional[torch.Tensor],     # [I] or None
    queries: torch.Tensor,            # [N, D] query sample fixing q_scale
    block_items: Optional[int] = None,
    seg_width: int = 64,
    user_tile: int = 256,
) -> PreparedItemsInt8:
    """Quantize the catalog for the int8 tier (see
    :class:`PreparedItemsInt8`); equal, element for element, to the
    reference's table and scales.  ``queries`` fixes the query and bias
    scale: the full user-query table, or a [1, D] row of per-dimension
    maxima.  The reference's ``clip_quantile`` experiment (measured worse
    there, off by default) is not carried over."""
    I, D = items.shape
    if seg_width <= 0 or seg_width & (seg_width - 1):
        raise ValueError("seg_width must be a power of two")
    if D > 1024:
        # |acc| <= D*127^2 + 32385 must stay below 2^24 (exact in f32) and
        # |acc| * seg_width below 2^31 (no int32 wrap)
        raise ValueError(f"int8 tier supports dim <= 1024 (got {D})")
    if block_items is None:
        block_items = _auto_block_items(D, 1, user_tile, seg_width)
    if block_items % seg_width:
        raise ValueError("block_items must be a multiple of seg_width")
    ipad = -(-I // block_items) * block_items
    dev = items.device

    v32 = items.to(torch.float32)
    # x * f32(1/127), not x / 127: the reference's compiler makes that
    # rewrite, and the scales must match it bit for bit
    col_scale = torch.clamp(v32.abs().amax(dim=0) * _INV127, min=1e-30)
    q_folded = queries.to(torch.float32).abs() * col_scale[None, :]
    q_scale = torch.clamp(q_folded.max() * _INV127, min=1e-30)
    b32 = (bias.to(torch.float32) if bias is not None
           else torch.zeros((I,), dtype=torch.float32, device=dev))
    b_int = torch.clamp(torch.round(b32 / q_scale), -_BIAS_INT_LIM,
                        _BIAS_INT_LIM)

    table = torch.zeros((ipad, D + 3), dtype=torch.float32, device=dev)
    table[:I, :D] = torch.round(v32 / col_scale[None, :])
    del v32
    table[:I, D:] = _bias_digits(b_int)
    table[I:, D:] = -127.0
    table = torch.clamp(table, -127.0, 127.0).to(torch.int8)
    return PreparedItemsInt8(table, col_scale, q_scale, I, D, block_items,
                             seg_width, user_tile)


def _quantize_queries(queries: torch.Tensor,
                      items: PreparedItemsInt8) -> torch.Tensor:
    """[B, D] float -> [B, D + 3] int8: ``q o col_scale / q_scale``,
    rounded half to even, clipped to +-127, then the digit weights."""
    q32 = queries.to(torch.float32) * items.col_scale[None, :]
    q8 = torch.clamp(torch.round(q32 / items.q_scale), -127.0, 127.0)
    w = q8.new_tensor(_INT8_WEIGHTS).expand(q8.shape[0], 3)
    return torch.cat([q8, w], dim=1).to(torch.int8)


def _int8_candidates(acc, row0, seg_width, seg_top, nseg):
    """Per-segment winners of an int32 [B, C] accumulator chunk whose
    columns are global rows ``row0 ..``, through the reference's packed
    key ``acc * seg_width + (seg_width - 1 - offset)`` (ties to the lowest
    offset; the second winner masks the first's key).  Returned in merge
    order as (acc int32, ids)."""
    B, C = acc.shape
    shift = seg_width.bit_length() - 1
    off = torch.arange(seg_width, dtype=torch.int32, device=acc.device)
    base = (row0 + torch.arange(C // seg_width, device=acc.device)
            * seg_width)[None, :]
    k3 = acc.reshape(B, -1, seg_width) * seg_width + (seg_width - 1 - off)
    vals, ids = [], []
    for rank in range(seg_top):
        key = k3.max(dim=2).values
        vals.append(key >> shift)                     # arithmetic shift
        ids.append(base + ((seg_width - 1) - (key & (seg_width - 1))))
        if rank + 1 < seg_top:
            k3 = torch.where(k3 == key[..., None],
                             torch.full_like(k3, _INT_NEG), k3)
    return _merge_order(vals, nseg), _merge_order(ids, nseg)


def _streaming_int8_ref_core(q8, items, k, seg_top,
                             chunk_elems: int = 1 << 28):
    table, seg_width = items.table, items.seg_width
    block_items = items.block_items
    B = q8.shape[0]
    n_rows = table.shape[0]               # a block multiple
    nblocks = n_rows // block_items
    nseg = block_items // seg_width
    qf = q8.to(torch.float32)
    chunk = max(block_items,
                (chunk_elems // max(B, 1)) // block_items * block_items)
    cand_v, cand_i = [], []
    for row0 in range(0, n_rows, chunk):
        t = table[row0:row0 + chunk].to(torch.float32)
        # integer operands and partial sums below 2^24: exact in f32
        acc = torch.matmul(qf, t.T).to(torch.int32)
        v, i = _int8_candidates(acc, row0, seg_width, seg_top, nseg)
        cand_v.append(v)
        cand_i.append(i)
    early = (nblocks - 1) * nseg * seg_top
    vals, ids, _ = _merge_candidates(
        torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1), k, early,
        torch.iinfo(torch.int32).min)
    vals = vals.to(torch.float32)
    vals = torch.where(vals > _PAD_FLOOR + 0.5, vals * items.q_scale,
                       torch.full_like(vals, NEG_INF))
    return vals, torch.clamp(ids, max=items.num_items - 1).to(torch.int32)


def topk_scores_streaming_int8_ref(
    queries: torch.Tensor,            # [B, D] float
    items: PreparedItemsInt8,
    k: int = 10,
    user_tile: int = 256,
    seg_top: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``topk_scores_streaming_int8`` (same
    arguments, the same result bit for bit), a chunk of items at a time."""
    if seg_top not in (1, 2):
        raise ValueError("seg_top must be 1 or 2")
    return _streaming_int8_ref_core(_quantize_queries(queries, items), items,
                                    min(k, items.num_items), seg_top)


def _streaming_int8_cuda(q8, items, k, seg_top):
    table = items.table.contiguous()
    seg_width, block_items = items.seg_width, items.block_items
    if table.dtype != torch.int8 or q8.shape[1] != table.shape[1]:
        raise ValueError(f"int8 kernel: queries {tuple(q8.shape)}, table "
                         f"{tuple(table.shape)} {table.dtype}")
    if not 1 <= k <= _MAX_STREAM_K:
        raise ValueError(f"int8 kernel takes 1 <= k <= 64, got {k}")
    if seg_width not in (32, 64, 128):
        raise ValueError(f"int8 kernel takes seg_width 32/64/128, "
                         f"got {seg_width}")
    dev = table.device
    if q8.device != dev:
        raise ValueError("queries and table must share one device")
    B, K = q8.shape
    n_rows = table.shape[0]
    if n_rows * seg_top >= 1 << 32:
        raise ValueError("too many items for the kernel's 32-bit tie keys")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    ncand = n_rows // seg_width * seg_top
    rows = max(1, min(B, _MAX_SCRATCH_BYTES // (ncand * 8)))
    keys = torch.empty((rows, ncand), dtype=torch.int64, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    q_scale = items.q_scale.to(torch.float32).reshape(1).contiguous()
    with torch.cuda.device(dev):
        for start in range(0, B, rows):
            n = min(rows, B - start)
            _kernels.launch(
                *INT8_ENTRY, q8[start].data_ptr(), table.data_ptr(),
                q_scale.data_ptr(), n, K, n_rows, items.num_items,
                seg_width, seg_top, block_items // seg_width,
                n_rows // block_items, k, keys.data_ptr(),
                vals[start].data_ptr(), ids[start].data_ptr(),
                _kernels.stream_of(table))
            topk_scores_streaming_int8.launches.add()
    return vals, ids


def topk_scores_streaming_int8(
    queries: torch.Tensor,            # [B, D] float
    items: PreparedItemsInt8,
    k: int = 10,
    user_tile: int = 256,
    seg_top: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate streaming top-k over an int8-quantized catalog (the
    reference's ``topk_scores_streaming_int8``): queries quantize per call
    against the prepared scales; each ``seg_width`` segment surfaces its
    best ``seg_top`` by integer score; the result is the top-k of those
    with dequantized scores (``acc * q_scale``).  Pass the winners through
    :func:`rescore_exact` for exact scores.  Winners at or below the
    padded rows' score ``_PAD_FLOOR`` come back as empty slots (NEG_INF).

    CUDA tensors launch the kernel (``csrc/topk_streaming_int8.cu``) or
    raise; CPU tensors run ``topk_scores_streaming_int8_ref``.  Each
    kernel launch adds one to ``topk_scores_streaming_int8.launches``."""
    if seg_top not in (1, 2):
        raise ValueError("seg_top must be 1 or 2")
    k = min(k, items.num_items)
    q8 = _quantize_queries(queries, items)
    dev = items.table.device
    if dev.type == "cpu":
        return _streaming_int8_ref_core(q8, items, k, seg_top)
    if dev.type != "cuda":
        raise RuntimeError(f"no int8 streaming kernel for {dev}")
    return _streaming_int8_cuda(q8, items, k, seg_top)


topk_scores_streaming_int8.launches = _kernels.LaunchCounter()
INT8_ENTRY = ("topk_streaming_int8", "ncf_topk_streaming_int8",
              "ppp" + "i" * 9 + "pppp")


# ------------------------------------------------------ exact top-k (B8)

_MAX_EXACT_K = 256     # the exact kernel's merge keeps at most 256 winners


def _exact_operands(queries, items, bias):
    if items.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32/bf16 items, got {items.dtype}")
    if queries.dim() != 2 or items.dim() != 2 or \
            queries.shape[1] != items.shape[1]:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"items {tuple(items.shape)}")
    dev = items.device
    if queries.device != dev or (bias is not None and bias.device != dev):
        raise ValueError("queries, items and bias must share one device")
    return (queries.to(torch.float32).contiguous(), items.contiguous(),
            None if bias is None else bias.to(torch.float32).contiguous())


def topk_scores_pallas_ref(
    queries: torch.Tensor,            # [B, D]
    items: torch.Tensor,              # [I, D]
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    block_items: int = 2048,
    user_tile: int = 256,
    chunk_elems: int = 1 << 28,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``topk_scores_pallas``: exact top-k by
    (value desc, id asc), a chunk of items at a time.  Scores at or below
    NEG_INF never surface; empty slots are NEG_INF with the reference's
    id, the best item before the last ``block_items`` block (else 0)."""
    B, I = queries.shape[0], items.shape[0]
    dev = queries.device
    early = (-(-I // block_items) - 1) * block_items
    chunk = max(block_items,
                (chunk_elems // max(B, 1)) // block_items * block_items)
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.zeros((B, k), dtype=torch.int32, device=dev)
    best_v = torch.full((B, 1), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for start in range(0, I, chunk):
        stop = min(start + chunk, I)
        s = _scores(queries, items[start:stop],
                    None if bias is None else bias[start:stop])
        s = torch.clamp(s, min=NEG_INF)
        if start < early:                 # the fill rule's candidates
            v, i = _topk_lowest_index(s[:, :min(stop, early) - start], 1)
            take = v > best_v             # strict: the earlier id wins ties
            best_v = torch.where(take, v, best_v)
            best_i = torch.where(take, i + start, best_i)
        bv, bi = _topk_lowest_index(s, min(k, stop - start))
        vals, sel = _topk_lowest_index(torch.cat([vals, bv], dim=1), k)
        ids = torch.gather(torch.cat([ids, bi + start], dim=1), 1, sel.long())
    fill = torch.where(best_v > NEG_INF, best_i, torch.zeros_like(best_i))
    empty = vals <= NEG_INF
    vals = torch.where(empty, torch.full_like(vals, NEG_INF), vals)
    return vals, torch.where(empty, fill.expand_as(ids), ids)


def _exact_cuda(q, items, bias, k, early):
    B, D = q.shape
    I = items.shape[0]
    dev = items.device
    if D > _MAX_TC_DIM:
        raise ValueError(f"exact kernel takes dim <= {_MAX_TC_DIM}, got {D}")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    # blocks walking the 128-item tiles per user tile, one a multiprocessor;
    # each leaves k keys per user
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nwalk = max(1, min(-(-I // 128), sms))
    ncand = nwalk * k
    rows = max(1, min(B, _MAX_SCRATCH_BYTES // (ncand * 8)))
    keys = torch.empty((rows, ncand), dtype=torch.int64, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    dtype_code = 0 if items.dtype == torch.float32 else 1
    with torch.cuda.device(dev):
        for start in range(0, B, rows):
            n = min(rows, B - start)
            _kernels.launch(
                *EXACT_ENTRY, q[start].data_ptr(), items.data_ptr(),
                bias.data_ptr() if bias is not None else None, dtype_code,
                n, D, I, k, early, nwalk, keys.data_ptr(),
                vals[start].data_ptr(), ids[start].data_ptr(),
                _kernels.stream_of(items))
            topk_scores_pallas.launches.add()
    return vals, ids


def topk_scores_pallas(
    queries: torch.Tensor,            # [B, D]
    items: torch.Tensor,              # [I, D]
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    block_items: int = 2048,
    user_tile: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the kernel computing its own product (the
    reference's ``topk_scores_pallas``): ties to the lower id, empty
    slots as in ``topk_scores_pallas_ref``; k at most 256 (ValueError
    above it, on every device).  ``block_items`` fixes the empty-slot id
    only.  CUDA tensors launch ``csrc/topk_exact.cu`` or raise; CPU
    tensors run the plain version.  Each launch adds one to
    ``topk_scores_pallas.launches``."""
    if not 1 <= k <= _MAX_EXACT_K:
        raise ValueError(f"topk_scores_pallas takes 1 <= k <= "
                         f"{_MAX_EXACT_K}, got {k}")
    q, t, b = _exact_operands(queries, items, bias)
    if t.device.type == "cpu":
        return topk_scores_pallas_ref(q, t, k, b, block_items)
    if t.device.type != "cuda":
        raise RuntimeError(f"no exact top-k kernel for {t.device}")
    early = (-(-t.shape[0] // block_items) - 1) * block_items
    return _exact_cuda(q, t, b, k, early)


topk_scores_pallas.launches = _kernels.LaunchCounter()
EXACT_ENTRY = ("topk_exact", "ncf_topk_exact", "ppp" + "i" * 7 + "pppp")


# ------------------------------------------------ segmented max (B9)

def _monotone_i32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> signed int32 (for negative floats flip the
    magnitude bits)."""
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def segmax_keys_ref(queries, items, bias, block_items: int = 2048,
                    seg_width: int = 128, chunk_elems: int = 1 << 28):
    """Plain version of the segmented kernel's output: per segment of
    ``seg_width`` items (catalog padded to ``block_items`` with NEG_INF
    scores), the max of the packed keys (monotone score with its low
    bits replaced by the offset).  int32 [B, Ipad / seg_width]."""
    B, I = queries.shape[0], items.shape[0]
    ipad = -(-I // block_items) * block_items
    chunk = max(block_items,
                (chunk_elems // max(B, 1)) // block_items * block_items)
    off = torch.arange(seg_width, dtype=torch.int32, device=items.device)
    out = []
    for start in range(0, ipad, chunk):
        stop = min(start + chunk, ipad)
        real = min(stop, I)
        s = _scores(queries, items[start:real],
                    None if bias is None else bias[start:real])
        if real < stop:
            s = torch.cat([s, torch.full((B, stop - real), NEG_INF,
                                         device=s.device)], dim=1)
        keys = ((_monotone_i32(s) & -seg_width).reshape(B, -1, seg_width)
                | off)
        out.append(keys.max(dim=2).values)
    return torch.cat(out, dim=1)


def segmax_key_violations(queries, items, bias, got, want, seg_width):
    """The tolerance of the segmented kernel's keys (``csrc/topk_segmax.cu``
    sums in another order than ``segmax_keys_ref``, so a key may move):
    where ``got`` and ``want`` differ, both winners are decoded from
    segment and offset and scored in f64, and the plain winner's score
    s_P may stand at most ``seg_width * ulp(|s_P| + 2 eps) + 2 eps`` above
    the kernel's, ``eps = 1e-5 * max sum_d |q_d v_d| + 1e-6`` (the
    tensor-core tile's stated error; the ulp is f32's).  Returns (keys
    that differ, of them those outside the rule)."""
    u, s = torch.nonzero(got != want, as_tuple=True)
    if u.numel() == 0:
        return 0, 0
    I = items.shape[0]

    def score(key):
        i = s.long() * seg_width + (key[u, s] & (seg_width - 1)).long()
        ic = i.clamp(max=I - 1)
        prod = queries[u].double() * items[ic].double()
        sc = prod.sum(1) + (0 if bias is None else bias[ic].double())
        return (torch.where(i < I, sc, torch.full_like(sc, -float("inf"))),
                prod.abs().sum(1))

    (sk, mk), (sp, mp) = score(got), score(want)
    eps = 1e-5 * torch.maximum(mk, mp) + 1e-6
    at = (sp.abs() + 2 * eps).float()
    ulp = torch.nextafter(at, torch.full_like(at, float("inf"))) - at
    ok = sp - sk <= seg_width * ulp.double() + 2 * eps
    return u.numel(), int((~ok).sum())


def _segmax_cuda(q, items, bias, block_items, seg_width):
    B, D = q.shape
    I = items.shape[0]
    dev = items.device
    if seg_width not in (32, 64, 128):
        raise ValueError(f"segmented kernel takes seg_width 32/64/128, "
                         f"got {seg_width}")
    if D > _MAX_TC_DIM:
        raise ValueError(f"segmented kernel takes dim <= {_MAX_TC_DIM}, "
                         f"got {D}")
    ipad = -(-I // block_items) * block_items
    keys = torch.empty((B, ipad // seg_width), dtype=torch.int32, device=dev)
    if B == 0:
        return keys
    with torch.cuda.device(dev):
        _kernels.launch(
            *SEGMAX_ENTRY, q.data_ptr(), items.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            0 if items.dtype == torch.float32 else 1, B, D, I, ipad,
            seg_width, keys.data_ptr(), _kernels.stream_of(items))
        topk_scores_segmented.launches.add()
    return keys


def _segmented_topk(keys, queries, items, bias, k, block_items, seg_width):
    """The reference's tail: top-k over the keys (ties to the lower
    position), ids from (position, packed offset), exact rescore."""
    nseg = block_items // seg_width
    top_keys, pos = _topk_lowest_index(keys, k)
    pos = pos.long()
    idxs = ((pos // nseg) * block_items + (pos % nseg) * seg_width
            + (top_keys & (seg_width - 1)).long())
    idxs = torch.clamp(idxs, max=items.shape[0] - 1).to(torch.int32)
    return rescore_exact(queries, items, bias, idxs)


def topk_scores_segmented_ref(queries, items, k: int = 10, bias=None,
                              block_items: int = 2048, user_tile: int = 256,
                              seg_width: int = 128):
    """Plain PyTorch version of ``topk_scores_segmented``."""
    if seg_width <= 0 or seg_width & (seg_width - 1):
        raise ValueError("seg_width must be a power of two")
    q, t, b = _exact_operands(queries, items, bias)
    keys = segmax_keys_ref(q, t, b, block_items, seg_width)
    return _segmented_topk(keys, queries, items, bias, k, block_items,
                           seg_width)


def topk_scores_segmented(
    queries: torch.Tensor,            # [B, D]
    items: torch.Tensor,              # [I, D]
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    block_items: int = 2048,
    user_tile: int = 256,
    seg_width: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k (the reference's ``topk_scores_segmented``): each
    ``seg_width`` segment surfaces one candidate by its score quantized
    to the bits above the packed offset (among equal quantized scores the
    highest offset wins); the top-k candidate keys are rescored exactly.
    The per-segment keys come from ``csrc/topk_segmax.cu`` on CUDA
    tensors (the tensor-core tile; rows of at most 128 values; each
    launch adds one to ``topk_scores_segmented.launches``) and from
    ``segmax_keys_ref`` on CPU tensors; the top-k and the rescore run as
    plain PyTorch on both, as in the reference.  The kernel sums in
    another order than the plain version, so a key may differ within the
    rule stated in its source."""
    if seg_width <= 0 or seg_width & (seg_width - 1):
        raise ValueError("seg_width must be a power of two")
    q, t, b = _exact_operands(queries, items, bias)
    if t.device.type == "cpu":
        keys = segmax_keys_ref(q, t, b, block_items, seg_width)
    elif t.device.type == "cuda":
        keys = _segmax_cuda(q, t, b, block_items, seg_width)
    else:
        raise RuntimeError(f"no segmented kernel for {t.device}")
    return _segmented_topk(keys, queries, items, bias, k, block_items,
                           seg_width)


topk_scores_segmented.launches = _kernels.LaunchCounter()
SEGMAX_ENTRY = ("topk_segmax", "ncf_topk_segmax", "ppp" + "i" * 6 + "pp")


# --------------------------------------------------------------- dispatch

def topk_scores(
    queries: torch.Tensor,
    items,
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    impl: str = "auto",
    seg_top: Optional[int] = None,    # None: 2, or 1 for the int8 tier
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch ('auto'): small catalogs take the exact dense path; large
    ones on the card take the streaming kernel (k <= 64), else the blocked
    exact path.  A :class:`PreparedItems` (bias baked in) goes to the
    streaming kernel and a :class:`PreparedItemsInt8` to the int8 tier,
    except k > 64, which unfolds the table (dequantized for int8) and
    takes the blocked exact path.  ``impl`` 'pallas' and 'segmented' pick
    the exact (B8) and segmented (B9) kernels."""
    if isinstance(items, PreparedItemsInt8):
        k = min(k, items.num_items)
        if bias is not None:
            raise ValueError(
                "bias must be None with PreparedItemsInt8 (it is baked in)")
        if k > _MAX_STREAM_K:
            raw, b = items.unfold()
            return topk_scores_xla(queries, raw, k, b)
        return topk_scores_streaming_int8(queries, items, k,
                                          seg_top=seg_top or 1)
    if seg_top is None:
        seg_top = 2
    if isinstance(items, PreparedItems):
        k = min(k, items.num_items)
        if k > _MAX_STREAM_K:
            raw, b = items.unfold()
            return topk_scores_xla(queries, raw, k, b)
        return topk_scores_streaming(queries, items, k, seg_top=seg_top)
    k = min(k, items.shape[0])
    if impl == "auto":
        small = queries.shape[0] * items.shape[0] * 4 <= 64 * 2**20
        if small:
            impl = "dense"
        elif queries.is_cuda and k <= _MAX_STREAM_K:
            impl = "streaming"
        else:
            impl = "xla"
    if impl == "dense":
        return topk_scores_dense(queries, items, k, bias)
    if impl == "pallas":
        return topk_scores_pallas(queries, items, k, bias)
    if impl == "streaming":
        return topk_scores_streaming(queries, items, k, bias,
                                     seg_top=seg_top)
    if impl == "segmented":
        return topk_scores_segmented(queries, items, k, bias)
    return topk_scores_xla(queries, items, k, bias)
