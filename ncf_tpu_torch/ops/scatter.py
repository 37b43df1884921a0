"""Embedding-gradient scatter-add: kernel B2.

Port of ``ncf_tpu/ops/pallas_scatter.py::onehot_scatter_add``:
``out[i] = sum over n with ids[n] == i of round_mode(grads[n])`` into an
f32 ``[num_rows, D]`` table; ids outside ``[0, num_rows)`` add nothing.
Each element is rounded first, by mode:

- ``split``: ``float(bf16(g)) + float(bf16(g - bf16(g)))`` (about 16
  mantissa bits; within rtol 2e-6 of the f32 sum);
- ``bf16``: ``float(bf16(g))``;
- ``f32``: ``g`` unchanged.

2-D ids ``[B, S]`` with grads ``[B, S, D]`` are flattened slot-major (all
rows of slot 0, then slot 1, ...), as the reference flattens them; other
shapes row-major.  The order of the adds is fixed: each element of row
``i`` is the sequential f32 sum, in flattened order, of that row's rounded
values, starting from 0.0 (what a sequential ``np.add.at`` in f32
computes).  So a result does not depend on the run or the device: the
kernel equals the plain version bit for bit.

CUDA tensors launch ``csrc/scatter_add.cu`` with one C call, or raise.
The kernel groups the flattened positions by id itself for tables of up
to ``ROW_LIMIT`` rows: up to ``SMALL_ROWS`` rows (and ``SMALL_N``
positions) in one kernel, a block a row, else by a stable counting sort.
Larger tables are grouped by ``torch.sort`` (bookkeeping: no gradient
value is added there).  Then each row's run is added in order and each
row written once.  CPU tensors take ``scatter_add_ref``, the plain
version.  ``scatter_add_grouped`` takes a grouping its caller already
made (the sparse combine's sort).

``scatter_fits`` and ``scatter_preferred`` are copies of the reference's
routing rules, with its TPU cost model: the port uses them only to choose
the same rounding mode as the JAX package for each table (see
``ops/embedding.py``), never as a model of the card.
"""

from __future__ import annotations

import functools

import torch

from ncf_tpu_torch.ops import _kernels

MODES = ("split", "bf16", "f32")
_MODE_CODE = {"split": 0, "bf16": 1, "f32": 2}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def round_mode(g: torch.Tensor, mode: str) -> torch.Tensor:
    """The f32 value each element adds under ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    if mode == "f32":
        return g.to(torch.float32)
    hi = g.to(torch.bfloat16).to(torch.float32)
    if mode == "bf16":
        return hi
    lo = (g.to(torch.float32) - hi).to(torch.bfloat16).to(torch.float32)
    return hi + lo


def _flat_ids(ids: torch.Tensor) -> torch.Tensor:
    """The reference's flattening: 2-D ids slot-major, others row-major."""
    return (ids.transpose(0, 1) if ids.dim() == 2 else ids).reshape(-1)


def _flat(ids: torch.Tensor, grads: torch.Tensor):
    """Flatten ids and grads alike (``_flat_ids``)."""
    if ids.dim() == 2:
        grads = grads.transpose(0, 1)
    return _flat_ids(ids), grads.reshape(-1, grads.shape[-1])


def scatter_add_ref(ids: torch.Tensor, grads: torch.Tensor, num_rows: int,
                    mode: str = "split") -> torch.Tensor:
    """Plain version of the kernel (same arguments, the same result bit for
    bit).  The order of the adds is written out: the flattened positions
    are sorted stably by id, each position's rank within its id's run is
    its level, and level r adds the r-th value of every id at once (the
    ids of a level are distinct), levels in order; so each element is the
    sequential f32 sum of its rounded values in flattened order, whatever
    the device and thread count."""
    flat_ids, flat_g = _flat(ids, grads)
    flat_ids = flat_ids.long()
    keep = (flat_ids >= 0) & (flat_ids < num_rows)
    out = torch.zeros((num_rows, grads.shape[-1]), dtype=torch.float32,
                      device=grads.device)
    kept, vals = flat_ids[keep], round_mode(flat_g[keep], mode)
    n = kept.numel()
    if n == 0:
        return out
    sid, order = torch.sort(kept, stable=True)
    pos = torch.arange(n, device=kept.device)
    first = torch.ones(n, dtype=torch.bool, device=kept.device)
    first[1:] = sid[1:] != sid[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_level = torch.sort(rank, stable=True).indices
    sid, src = sid[by_level], order[by_level]
    start = 0
    for count in torch.bincount(rank).tolist():
        level = sid[start:start + count]
        out[level] = out[level] + vals[src[start:start + count]]
        start += count
    return out


# csrc/scatter_add.cu's constants: the largest table the kernel groups by
# itself (its shared memory), the small tables' route (rows, positions),
# its grouping blocks' positions (at least, at most, and the blocks before
# chunks grow), warps a block, and the runs longer than which a row takes
# the long path
ROW_LIMIT = 11264
SMALL_ROWS, SMALL_N = 64, 32768
CHUNK, MAX_CHUNK, MAX_CHUNKS = 2048, 65280, 256
WARPS = 8
LONG_RUN = 128
_THREADS = 32 * WARPS
_IDS = (torch.int32, torch.int64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def counting_route(num_rows: int, n: int) -> bool:
    """Whether the kernel groups ``n`` positions into ``num_rows`` rows by
    its own counting sort (else the wrapper sorts)."""
    return num_rows <= ROW_LIMIT and n <= MAX_CHUNKS * MAX_CHUNK


def small_route(num_rows: int, n: int) -> bool:
    """Whether the counting route takes its small tables' kernel: a block
    a (row, 32 columns) lists its row's positions in order itself, so no
    grouping kernel runs and no scratch is needed."""
    return num_rows <= SMALL_ROWS and n <= SMALL_N


def chunk_size(n: int) -> int:
    """Flattened positions a grouping block takes: ``CHUNK``, or more
    (a multiple of the block's threads) so that there are at most
    ``MAX_CHUNKS`` blocks."""
    if n <= CHUNK * MAX_CHUNKS:
        return CHUNK
    return _round_up(-(-n // MAX_CHUNKS), _THREADS)


def num_chunks(n: int) -> int:
    return max(1, -(-n // chunk_size(n)))


@functools.lru_cache(maxsize=256)
def scratch_ints(n: int, num_rows: int, counting: bool) -> int:
    """int32 entries of the kernel's scratch: none for the small tables'
    route; else the list of long runs and each sorted position's row of
    grads, and for the counting route the chunk counts, the CSR of runs
    and the flags and counter of its scan, else each row's start and end
    and each sorted position's row."""
    if counting and small_route(num_rows, n):
        return 0
    lists = 1 + min(num_rows, n // (LONG_RUN + 1)) + n
    if counting:
        return (num_chunks(n) * num_rows + num_rows + 1
                + num_rows // _THREADS + 2 + lists)
    return 2 * num_rows + lists + n


def _launch(ids, id_bytes, rows, slots, keys, perm, grads, num_rows, mode,
            counting):
    """One C call: every phase on the current stream, one scratch."""
    code = _DTYPE_CODE.get(grads.dtype)
    if code is None:
        raise TypeError(f"the scatter kernel takes f32/bf16 grads, got "
                        f"{grads.dtype}")
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")
    if not grads.is_contiguous():
        grads = grads.contiguous()
    D = grads.shape[-1]
    dev = grads.device
    out = torch.empty((num_rows, D), dtype=torch.float32, device=dev)
    need = scratch_ints(rows * slots, num_rows, counting)
    scratch = (torch.empty(need, dtype=torch.int32, device=dev) if need
               else None)
    with _kernels.on_device(dev):
        _kernels.launch(
            *C_ENTRY, 0 if ids is None else ids.data_ptr(), id_bytes, rows,
            slots, 0 if keys is None else keys.data_ptr(),
            0 if keys is None else keys.element_size(),
            0 if perm is None else perm.data_ptr(), grads.data_ptr(), code,
            D, num_rows, _MODE_CODE[mode],
            0 if scratch is None else scratch.data_ptr(), need,
            out.data_ptr(), _kernels.stream_of(grads))
    onehot_scatter_add.launches.add()
    return out


def _scatter_cuda(ids, grads, num_rows, mode):
    # the host's work a call: no copy of contiguous int32/int64 ids, the
    # 2-D ids read slot-major by the kernel, one scratch
    if ids.device != grads.device:
        raise ValueError("ids and grads must share one device")
    if grads.shape[:-1] != ids.shape or grads.dim() < 1:
        raise ValueError(f"ids {tuple(ids.shape)} do not index grads "
                         f"{tuple(grads.shape)}")
    if ids.dtype not in _IDS:
        ids = ids.to(torch.int32)
    if ids.dim() == 2:
        rows, slots = ids.shape
    else:
        rows, slots = ids.numel(), 1
    if counting_route(num_rows, rows * slots):
        if not ids.is_contiguous():
            ids = ids.contiguous()
        return _launch(ids, ids.element_size(), rows, slots, None, None,
                       grads, num_rows, mode, True)
    keys, perm = torch.sort(_flat_ids(ids), stable=True)
    return _launch(None, 0, rows, slots, keys, perm, grads, num_rows, mode,
                   False)


def _grouped_cuda(order, sorted_rows, grads, num_rows, mode):
    if order.device != grads.device:
        raise ValueError("order and grads must share one device")
    if sorted_rows.dtype not in _IDS:
        sorted_rows = sorted_rows.to(torch.int32)
    if not sorted_rows.is_contiguous():
        sorted_rows = sorted_rows.contiguous()
    if order.dtype != torch.int64 or not order.is_contiguous():
        order = order.to(torch.int64).contiguous()
    return _launch(None, 0, order.numel(), 1, sorted_rows, order, grads,
                   num_rows, mode, False)


def scatter_add_grouped_ref(order: torch.Tensor, sorted_rows: torch.Tensor,
                            grads: torch.Tensor, num_rows: int,
                            mode: str = "split") -> torch.Tensor:
    """Plain version of ``scatter_add_grouped``: B2 over the ids the
    grouping stands for (``ids[order[k]] = sorted_rows[k]``)."""
    ids = torch.empty_like(sorted_rows)
    ids[order] = sorted_rows
    return scatter_add_ref(ids, grads, num_rows, mode)


def scatter_add_grouped(order: torch.Tensor, sorted_rows: torch.Tensor,
                        grads: torch.Tensor, num_rows: int, *,
                        mode: str = "split") -> torch.Tensor:
    """B2 given its grouping: ``sorted_rows`` int [N] ascending, ``order``
    int [N] the position in ``grads`` [N, D] of each, equal rows in
    increasing positions (what ``torch.sort(ids, stable=True)`` returns).
    Equal bit for bit to ``onehot_scatter_add(ids, grads, num_rows)`` for
    those ids, without sorting again; the kernel trusts the grouping.
    Each kernel launch adds one to ``onehot_scatter_add.launches``."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    if (order.dim() != 1 or sorted_rows.shape != order.shape
            or grads.dim() != 2 or grads.shape[0] != order.numel()):
        raise ValueError(f"order {tuple(order.shape)}, sorted_rows "
                         f"{tuple(sorted_rows.shape)} and grads "
                         f"{tuple(grads.shape)} do not match")
    if grads.device.type == "cpu":
        return scatter_add_grouped_ref(order, sorted_rows, grads, num_rows,
                                       mode)
    if grads.device.type != "cuda":
        raise RuntimeError(f"no scatter kernel for {grads.device}")
    return _grouped_cuda(order, sorted_rows, grads, num_rows, mode)


def onehot_scatter_add(ids: torch.Tensor, grads: torch.Tensor,
                       num_rows: int, *, mode: str = "split") -> torch.Tensor:
    """Dense table gradient: ids int [N] or [B, S], grads [..., D] ->
    f32 [num_rows, D].  Each kernel launch adds one to
    ``onehot_scatter_add.launches``."""
    if mode not in MODES:
        raise ValueError(f"unknown scatter mode {mode!r}")
    if grads.device.type == "cpu":
        return scatter_add_ref(ids, grads, num_rows, mode)
    if grads.device.type != "cuda":
        raise RuntimeError(f"no scatter kernel for {grads.device}")
    return _scatter_cuda(ids, grads, num_rows, mode)


onehot_scatter_add.launches = _kernels.LaunchCounter()
# (library, C function, argument codes of ``_kernels.bind``)
C_ENTRY = ("scatter_add", "ncf_scatter_add", "piiipippiiiiplpp")


# ------------------------------------------- the reference's routing rules

_VMEM_ACC_BUDGET = 10 * 1024 * 1024
_XLA_NS_PER_ROW = 9.0
_KERNEL_MAC_PER_S = 98.5e12
_KERNEL_OVERHEAD_US = 10.0


def scatter_fits(num_rows: int, d: int, n: int) -> bool:
    """The reference's gate: the TPU kernel's accumulator fits its VMEM
    budget, there are at least 2048 ids, and ``d % 8 == 0``."""
    acc_bytes = _round_up(num_rows, 128) * d * 4
    return acc_bytes <= _VMEM_ACC_BUDGET and n >= 2048 and d % 8 == 0


def _kernel_cost_us(num_rows: int, d: int, n: int, mode: str) -> float:
    macs = _round_up(num_rows, 128) * n * d * (2 if mode == "split" else 1)
    return macs / _KERNEL_MAC_PER_S * 1e6 + _KERNEL_OVERHEAD_US


def scatter_preferred(num_rows: int, d: int, n: int,
                      mode: str = "split") -> bool:
    """Whether the reference routes this shape to its kernel under
    ``auto``/``fast`` (its TPU cost model, copied)."""
    if not scatter_fits(num_rows, d, n):
        return False
    return _kernel_cost_us(num_rows, d, n, mode) < _XLA_NS_PER_ROW * n / 1e3
