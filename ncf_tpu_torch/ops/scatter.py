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

CUDA tensors sort the flattened ids stably (``torch.sort``, bookkeeping:
no gradient value is added there) and launch ``csrc/scatter_add.cu``,
which adds each row's run in order and writes each row once, or raise;
CPU tensors take ``scatter_add_ref``, the plain version.

``scatter_fits`` and ``scatter_preferred`` are copies of the reference's
routing rules, with its TPU cost model: the port uses them only to choose
the same rounding mode as the JAX package for each table (see
``ops/embedding.py``), never as a model of the card.
"""

from __future__ import annotations

import torch

from ncf_tpu_torch.ops import _kernels

MODES = ("split", "bf16", "f32")
_MODE_CODE = {"split": 0, "bf16": 1, "f32": 2}
_LONG_RUN = 128      # the kernel's kLongRun: longer runs get a block each


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


def _runs(ids: torch.Tensor):
    """The kernel's bookkeeping: the flattened ids as int32 sorted stably
    (equal ids keep their flattened order) with their flattened positions
    (int64), and the ``(rows, slots)`` that map a flattened position ``f``
    to its row of grads: ``f`` itself when ``slots == 1``, else ``(f %
    rows) * slots + f // rows`` (2-D ids, flattened slot-major)."""
    flat = _flat_ids(ids).to(torch.int32)
    sorted_ids, perm = torch.sort(flat, stable=True)
    rows, slots = tuple(ids.shape) if ids.dim() == 2 else (flat.numel(), 1)
    return sorted_ids, perm, rows, slots


def _scatter_cuda(ids, grads, num_rows, mode):
    if grads.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the scatter kernel takes f32/bf16 grads, got "
                        f"{grads.dtype}")
    if ids.device != grads.device:
        raise ValueError("ids and grads must share one device")
    if grads.dim() < 1 or grads.shape[:-1] != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} do not index grads "
                         f"{tuple(grads.shape)}")
    D = grads.shape[-1]
    sorted_ids, perm, rows, slots = _runs(ids)
    grads = grads.contiguous()
    out = torch.empty((num_rows, D), dtype=torch.float32, device=grads.device)
    n = sorted_ids.numel()
    longs = torch.empty(1 + n // (_LONG_RUN + 1), dtype=torch.int32,
                        device=grads.device)
    with _kernels.on_device(grads.device):
        _kernels.launch(
            *C_ENTRY, sorted_ids.data_ptr(), perm.data_ptr(),
            grads.data_ptr(), 0 if grads.dtype == torch.float32 else 1, n,
            rows, slots, D, num_rows, _MODE_CODE[mode], longs.data_ptr(),
            out.data_ptr(), _kernels.stream_of(grads))
    onehot_scatter_add.launches.add()
    return out


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
C_ENTRY = ("scatter_add", "ncf_scatter_add", "pppiiiiiiippp")


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
