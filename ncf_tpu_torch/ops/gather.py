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

import torch

from ncf_tpu_torch.ops import _kernels
from ncf_tpu_torch.ops.scatter import onehot_scatter_add


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids]``, [..., D]."""
    return table[ids.long()]


def _gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if table.dim() != 2:
        raise ValueError(
            f"gather takes a [N, D] table, got {tuple(table.shape)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather takes int32/int64 ids, got {ids.dtype}")
    if ids.device != table.device:
        raise ValueError("table and ids must share one device")
    table = table.contiguous()
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 4 or table.data_ptr() % 4:
        raise ValueError(f"gather kernel takes rows of a multiple of 4 "
                         f"bytes, got {row_bytes} ({table.dtype} x "
                         f"{table.shape[1]})")
    flat = ids.reshape(-1).contiguous()
    out = torch.empty((flat.numel(), table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if flat.numel():
        with torch.cuda.device(table.device):
            _kernels.launch(
                *C_ENTRY, table.data_ptr(), flat.data_ptr(),
                int(flat.dtype == torch.int64), flat.numel(), row_bytes,
                table.shape[0],
                out.data_ptr(), _kernels.stream_of(table))
            gather_rows.launches.add()
    return out.reshape(*ids.shape, table.shape[1])


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
C_ENTRY = ("gather", "ncf_gather", "ppilil" + "pp")


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
