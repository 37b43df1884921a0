"""Top-k candidate scoring: scores = Q @ T^T (+ bias) -> top-k.

Port of ``ncf_tpu/ops/topk.py``.  Implementations with the reference's
call semantics:

- ``topk_scores_streaming`` — the retrieval kernel for large catalogs:
  per-segment top-``seg_top`` then a top-k merge, never materialising
  the [B, I] score matrix.  On CUDA tensors it launches the hand-written
  kernel in ``csrc/topk_streaming.cu``; on CPU tensors it runs
  ``topk_scores_streaming_ref``, its plain PyTorch version.
- ``topk_scores_dense`` — one matmul + a top-k (small catalogs).
- ``topk_scores_xla``   — the blocked exact path with a running merge
  (name kept from the reference, where XLA ran it).
- ``rescore_exact``     — exact re-score + re-sort of candidates.

Ties: the reference's ``lax.top_k`` breaks ties to the lower index and
``torch.topk`` promises nothing, so the plain paths sort stably.  The
streaming functions order equal values as the reference's running merge
``[carry; m1 of every segment; m2 of every segment]`` does: by item block
(``block_items`` items), then segment maxima before runners-up, then by
segment.  Slots beyond the candidates come back as ``NEG_INF`` with the
reference's id there: the best candidate of the blocks before the last
(the carry's top-1 entering the last block), or 0 with one block.

The TPU-only operand tricks do not carry over: ``PreparedItems`` keeps
the bias as an f32 vector added in the kernel's epilogue (the TPU folded
it into three bf16 matmul columns).  ``block_items`` is sized by the
reference's own rule (``_auto_block_items``) because it decides those
tie and empty-slot ids; the CUDA kernel picks its own tiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ncf_tpu_torch.ops import _kernels

NEG_INF = -3.0e38
_MAX_STREAM_K = 64     # the merge keeps at most 64 winners per user
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


def prepare_items_int8(*args, **kwargs):
    """The int8 tier (TPU kernel ``topk_scores_streaming_int8``) is not
    ported yet."""
    raise NotImplementedError("the int8 retrieval tier is not ported yet")


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
    # [B, blocks, nseg] per rank -> [B, blocks, seg_top, nseg] -> flat
    def order(parts):
        t = torch.stack([x.reshape(B, -1, nseg) for x in parts], dim=2)
        return t.reshape(B, -1)
    return order(vals), order(ids)


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
    cand_v = torch.cat(cand_v, dim=1)
    cand_i = torch.cat(cand_i, dim=1)
    # a stable sort keeps the merge order among equal values
    vals, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    ids = torch.gather(cand_i, 1, order[:, :k])
    if vals.shape[1] < k:                 # fewer candidates than k
        pad = k - vals.shape[1]
        vals = torch.cat([vals, torch.full((B, pad), NEG_INF,
                                           device=q.device)], dim=1)
        ids = torch.cat([ids, torch.zeros((B, pad), dtype=ids.dtype,
                                          device=q.device)], dim=1)
    # empty slots: the best candidate of the blocks before the last (the
    # carry's top-1 entering the last block), else 0
    early = (nblocks - 1) * (block_items // seg_width) * seg_top
    fill = torch.zeros((B,), dtype=ids.dtype, device=q.device)
    if early > 0:
        ev = cand_v[:, :early]
        top = torch.argmax((ev == ev.max(dim=1, keepdim=True).values).to(
            torch.int8), dim=1, keepdim=True)     # first of the best
        best_v = torch.gather(ev, 1, top)[:, 0]
        fill = torch.where(best_v > NEG_INF,
                           torch.gather(cand_i[:, :early], 1, top)[:, 0], fill)
    empty = vals <= NEG_INF
    vals = torch.where(empty, torch.full_like(vals, NEG_INF), vals)
    ids = torch.where(empty, fill[:, None].expand_as(ids), ids)
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


# --------------------------------------------------------------- dispatch

def topk_scores(
    queries: torch.Tensor,
    items,
    k: int = 10,
    bias: Optional[torch.Tensor] = None,
    impl: str = "auto",
    seg_top: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch ('auto'): small catalogs take the exact dense path; large
    ones on the card take the streaming kernel (k <= 64), else the blocked
    exact path.  A :class:`PreparedItems` (bias baked in) goes to the
    streaming kernel, except k > 64, which unfolds the table and takes
    the blocked exact path."""
    if impl in ("pallas", "segmented"):
        raise NotImplementedError(f"impl={impl!r} is not ported yet")
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
    if impl == "streaming":
        return topk_scores_streaming(queries, items, k, bias,
                                     seg_top=seg_top)
    return topk_scores_xla(queries, items, k, bias)
