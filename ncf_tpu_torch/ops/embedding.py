"""Embedding lookup: a row gather whose backward is the scatter-add
kernel B2, or under ``set_impl("pallas")`` the gather kernel B7.

Port of ``ncf_tpu/ops/embedding.py``.  Under the default ``"xla"`` the
forward is ``table[ids]`` and the backward adds the output gradient into
an f32 ``[N, D]`` table (``ops/scatter.py::onehot_scatter_add``: the
kernel on the card, its plain version on the CPU) and casts it to the
table's dtype.

The rounding mode follows the reference's routing on a TPU
(``embedding.py:121-134``): where the JAX package would run its scatter
kernel, the configured mode (``split`` under ``auto``, ``bf16`` under
``fast``); where it would run XLA's scatter, ``f32``.  So on the card
every table gradient goes through B2.  On the TPU XLA's scatter adds in
the table's dtype; B2 always adds in f32.

Under ``"pallas"`` every lookup goes through ``ops/gather.py`` (B7) and
its backward is a scatter-add in the table's dtype, as the reference's
``_IMPL == "pallas"`` branch wins before its scatter routing.
"""

from __future__ import annotations

import torch

from ncf_tpu_torch.ops.gather import pallas_embedding_lookup
from ncf_tpu_torch.ops.scatter import (onehot_scatter_add, scatter_fits,
                                       scatter_preferred)

_IMPL = "xla"
_SCATTER_IMPL = "auto"
_SCATTER_MODE = "split"


def set_impl(impl: str) -> None:
    """Forward impl: ``"xla"`` (default, ``table[ids]``) or ``"pallas"``
    (the gather kernel B7)."""
    global _IMPL
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown embedding impl {impl!r}")
    _IMPL = impl


def get_impl() -> str:
    return _IMPL


def set_scatter_impl(impl: str, mode: str = "split") -> None:
    """impl: ``auto`` (the reference's cost model picks, ``mode``
    rounding), ``fast`` (the same with ``bf16``), ``pallas`` (``mode``
    wherever the reference's kernel fits) or ``xla`` (``f32``
    everywhere)."""
    global _SCATTER_IMPL, _SCATTER_MODE
    if impl not in ("auto", "xla", "pallas", "fast"):
        raise ValueError(f"unknown scatter impl {impl!r}")
    if mode not in ("split", "bf16", "f32"):
        raise ValueError(f"unknown scatter mode {mode!r}")
    _SCATTER_IMPL = impl
    _SCATTER_MODE = "bf16" if impl == "fast" else mode


def get_scatter_impl() -> str:
    return _SCATTER_IMPL


def backward_mode(num_rows: int, d: int, n: int) -> str:
    """The rounding mode of a table gradient of ``num_rows x d`` from
    ``n`` ids under the current setting."""
    if _SCATTER_IMPL == "xla":
        return "f32"
    if _SCATTER_IMPL == "pallas":
        use = scatter_fits(num_rows, d, n)
    else:
        use = scatter_preferred(num_rows, d, n, _SCATTER_MODE)
    return _SCATTER_MODE if use else "f32"


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = tuple(table.shape)
        ctx.table_dtype = table.dtype
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows, d = ctx.table_shape
        mode = backward_mode(rows, d, ids.numel())
        grad = onehot_scatter_add(ids, g, rows, mode=mode)
        return grad.to(ctx.table_dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [N, D], ids int[...]  ->  [..., D]."""
    if _IMPL == "pallas":
        return pallas_embedding_lookup(table, ids)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids.long()]
    return _Lookup.apply(table, ids)
