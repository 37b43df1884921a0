"""Fused temporal lookup-sum: kernel B3.

Port of ``ncf_tpu/ops/pallas_temporal.py::fused_lookup_sum``:
``sum_k tables[k][ids[k]]`` for ids int ``[K, B]`` and K <= 4 tables of
one width -> f32 ``[B, dt]``, added in table order in f32; an id outside a
table's rows contributes 0.

CUDA tensors launch ``csrc/temporal_sum.cu`` or raise; CPU tensors take
``lookup_sum_ref``, the plain version.  The two add in the same order, so
they agree bit for bit.  On a TPU the kernel's one-hot matmul at default
precision passes the table values through bf16; the CPU reference and
this port are exact f32.

The backward (``fused_lookup_sum`` is an ``autograd.Function``) sends each
learned table's gradient through the scatter kernel B2 in ``split`` mode
where the reference's ``scatter_fits`` admits the shape, else in ``f32``
(``pallas_temporal.py:107-120``); a table that does not require a gradient
(the sinusoid ``pe``) gets none.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ncf_tpu_torch.ops import _kernels
from ncf_tpu_torch.ops.scatter import onehot_scatter_add, scatter_fits

MAX_TABLES = 4


def lookup_sum_ref(ids: torch.Tensor,
                   tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of the kernel: ids int [K, B] -> f32 [B, dt]."""
    out = None
    for k, t in enumerate(tables):
        idk = ids[k].long()
        valid = (idk >= 0) & (idk < t.shape[0])
        rows = t.to(torch.float32)[idk.clamp(0, t.shape[0] - 1)]
        v = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        out = v if out is None else out + v
    return out


def _lookup_sum_cuda(ids, tables):
    K, B = ids.shape
    dt = tables[0].shape[1]
    dev = ids.device
    for t in tables:
        if t.device != dev:
            raise ValueError("ids and tables must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the temporal kernel takes f32 tables, got "
                            f"{t.dtype}")
    ids = ids.to(torch.int32).contiguous()
    ts = [t.contiguous() for t in tables]
    out = torch.empty((B, dt), dtype=torch.float32, device=dev)
    args = []
    for k in range(MAX_TABLES):
        args += ([ts[k].data_ptr(), ts[k].shape[0]] if k < K else [None, 0])
    with torch.cuda.device(dev):
        _kernels.launch(*C_ENTRY, ids.data_ptr(), K, B, dt, *args,
                        out.data_ptr(), _kernels.stream_of(ids))
    fused_lookup_sum.launches.add()
    return out


def _forward(ids: torch.Tensor, tables) -> torch.Tensor:
    if ids.dim() != 2 or ids.shape[0] != len(tables):
        raise ValueError(f"ids {tuple(ids.shape)} do not match "
                         f"{len(tables)} tables")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"takes 1..{MAX_TABLES} tables, got {len(tables)}")
    if len({t.shape[1] for t in tables}) != 1:
        raise ValueError("the tables must share one width")
    if ids.device.type == "cpu":
        return lookup_sum_ref(ids, tables)
    if ids.device.type != "cuda":
        raise RuntimeError(f"no temporal kernel for {ids.device}")
    return _lookup_sum_cuda(ids, tables)


class _FusedLookupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, *tables):
        ctx.save_for_backward(ids)
        ctx.shapes = [(t.shape[0], t.shape[1], t.dtype) for t in tables]
        return _forward(ids, tables)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grads = []
        for k, (rows, d, dtype) in enumerate(ctx.shapes):
            if not ctx.needs_input_grad[k + 1]:
                grads.append(None)
                continue
            mode = "split" if scatter_fits(rows, d, ids.shape[1]) else "f32"
            grads.append(onehot_scatter_add(ids[k], g, rows,
                                            mode=mode).to(dtype))
        return (None, *grads)


def fused_lookup_sum(ids: torch.Tensor,
                     tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum_k tables[k][ids[k]]``: ids int [K, B], tables K x [rows_k,
    dt] -> f32 [B, dt] (the reference's signature, without
    ``interpret``).  Each kernel launch adds one to
    ``fused_lookup_sum.launches``."""
    tables = tuple(tables)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _FusedLookupSum.apply(ids, *tables)
    return _forward(ids, tables)


fused_lookup_sum.launches = _kernels.LaunchCounter()
# (library, C function, argument codes of ``_kernels.bind``)
C_ENTRY = ("temporal_sum", "ncf_temporal_sum", "piiipipipipipp")
