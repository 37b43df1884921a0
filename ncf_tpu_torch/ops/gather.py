"""Row gather ``table[ids]``: kernel B7.

Port of ``ncf_tpu/ops/pallas_embedding.py::pallas_embedding_lookup``, the
lookup that ``ops.embedding.set_impl("pallas")`` selects.  The forward
gathers rows with the hand-written kernel in ``csrc/gather.cu`` on CUDA
tensors and with ``gather_rows_ref`` (``table[ids]``) on CPU tensors.  The
backward scatter-adds the output gradient through the deterministic
scatter-add B2 in ``f32`` mode (``ops/scatter.py``: the kernel on the card,
its plain version on the CPU, bit for bit alike), the ids flattened
row-major, then casts the f32 sum to the table's dtype.  The reference's
backward (``pallas_embedding.py:152-161``) is an XLA scatter that adds in
the table's dtype: for a bf16 table the port rounds once, after an f32
sum, where the reference rounds at every add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ncf_tpu_torch.ops import _kernels
from ncf_tpu_torch.ops.scatter import onehot_scatter_add

# csrc/gather.cu's constants: threads a block, the blocks an SM holds at
# least (its ``__launch_bounds__``)
THREADS = 256
BLOCKS_PER_SM = 4
# a warp copies 32 rows at a time (one coalesced load of their ids)
ROWS_PER_BLOCK = THREADS


class GatherPlan(NamedTuple):
    """How ``csrc/gather.cu`` copies rows: ``width`` bytes a word,
    ``group`` threads a row (``1 << tlog``), ``grid`` blocks of
    ``ROWS_PER_BLOCK`` rows a pass."""
    width: int
    tlog: int
    grid: int

    @property
    def group(self) -> int:
        return 1 << self.tlog


def launch_plan(row_bytes: int, table_ptr: int, out_ptr: int, n: int,
                sms: int) -> GatherPlan:
    """The kernel's plan for ``n`` rows of ``row_bytes`` (a multiple of
    4) between the two base addresses on a card of ``sms`` SMs: the
    widest word (16, 8 or 4 bytes) that divides the row and both
    addresses; a group of the row's words rounded up to a power of two,
    at most 32 threads; a grid of what the rows need, at most what the
    card holds resident."""
    width = next(w for w in (16, 8, 4)
                 if row_bytes % w == 0 and table_ptr % w == 0
                 and out_ptr % w == 0)
    words = row_bytes // width
    tlog = min(5, (words - 1).bit_length())
    grid = max(1, min(-(-n // ROWS_PER_BLOCK), sms * BLOCKS_PER_SM))
    return GatherPlan(width, tlog, grid)


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids]``, [..., D]."""
    return table[ids.long()]


_sms = {}
_IDS = (torch.int32, torch.int64)


def _sm_count(device_index: int) -> int:
    n = _sms.get(device_index)
    if n is None:
        n = _sms[device_index] = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return n


@functools.lru_cache(maxsize=512)
def _plan(row_bytes: int, align: int, n: int, sms: int) -> GatherPlan:
    # ``align``: the low bits of both addresses ORed; a word divides both
    # addresses exactly when it divides that
    return launch_plan(row_bytes, align, align, n, sms)


def _gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    # the host's work a call, which paces back-to-back calls of this
    # µs-sized kernel: no copy of contiguous inputs, the output allocated
    # in its final shape, the plan cached, the C function bound once
    if table.dim() != 2:
        raise ValueError(
            f"gather takes a [N, D] table, got {tuple(table.shape)}")
    if ids.dtype not in _IDS:
        raise TypeError(f"gather takes int32/int64 ids, got {ids.dtype}")
    if ids.device != table.device:
        raise ValueError("table and ids must share one device")
    if not table.is_contiguous():
        table = table.contiguous()
    rows, d = table.shape
    row_bytes = d * table.element_size()
    tp = table.data_ptr()
    if row_bytes % 4 or tp % 4:
        raise ValueError(f"gather kernel takes rows of a multiple of 4 "
                         f"bytes, got {row_bytes} ({table.dtype} x {d})")
    if not ids.is_contiguous():
        ids = ids.contiguous()
    out = table.new_empty((*ids.shape, d))
    n = ids.numel()
    if n:
        op = out.data_ptr()
        p = _plan(row_bytes, (tp | op) & 15, n,
                  _sm_count(table.get_device()))
        with _kernels.on_device(table.device):
            _kernels.launch(
                *C_ENTRY, tp, ids.data_ptr(), int(ids.dtype == torch.int64),
                n, row_bytes, rows, p.width, p.tlog, p.grid, op,
                _kernels.stream_of(table))
        gather_rows.launches.add()
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table [N, D]``, ``ids int[...]`` -> ``[..., D]``, bit for bit
    ``table[ids]`` (a negative id counts from the end).  Every id must lie
    in ``[-N, N)``: the kernel does not check.  Rows must be a multiple
    of 4 bytes, as in the reference's gather (``ValueError`` otherwise).
    CUDA tensors launch the kernel or raise; CPU tensors run
    ``gather_rows_ref``.  Each launch adds one to
    ``gather_rows.launches``."""
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    if table.device.type != "cuda":
        raise RuntimeError(f"no gather kernel for {table.device}")
    return _gather_cuda(table, ids)


gather_rows.launches = _kernels.LaunchCounter()
# (library, C function, argument codes of ``_kernels.bind``)
C_ENTRY = ("gather", "ncf_gather", "ppilil" + "iii" + "pp")


class _PallasLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = tuple(table.shape)
        ctx.table_dtype = table.dtype
        return gather_rows(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows, d = ctx.table_shape
        flat = ids.reshape(-1)
        flat = torch.where(flat < 0, flat + rows, flat)   # ids in [-N, N)
        grad = onehot_scatter_add(flat, g.reshape(-1, d), rows, mode="f32")
        return grad.to(ctx.table_dtype), None


def pallas_embedding_lookup(table: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """Gather rows through B7; differentiable in ``table``."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return gather_rows(table, ids)
    return _PallasLookup.apply(table, ids)
