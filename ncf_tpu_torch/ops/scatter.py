"""Embedding-gradient scatter-add: kernel B2.

Port of ``ncf_tpu/ops/pallas_scatter.py::onehot_scatter_add``:
``out[i] = sum over n with ids[n] == i of round_mode(grads[n])`` into an
f32 ``[num_rows, D]`` table; ids outside ``[0, num_rows)`` add nothing.
Each element is rounded first, by mode:

- ``split``: ``float(bf16(g)) + float(bf16(g - bf16(g)))`` (about 16
  mantissa bits; within rtol 2e-6 of the f32 sum);
- ``bf16``: ``float(bf16(g))``;
- ``f32``: ``g`` unchanged.

2-D ids ``[B, S]`` with grads ``[B, S, D]`` are taken slot-major (all rows
of slot 0, then slot 1, ...), as the reference flattens them; the sum
does not depend on the order.

CUDA tensors launch ``csrc/scatter_add.cu`` (one warp per input row, f32
``atomicAdd``) or raise; CPU tensors take ``scatter_add_ref``, the plain
version.  Atomics add in an order that changes from run to run, so two
runs agree within a few f32 ulps of ``sum |g|`` per element, not bit for
bit.

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


def _flat(ids: torch.Tensor, grads: torch.Tensor):
    """Flatten like the reference: 2-D ids slot-major."""
    if ids.dim() == 2:
        return (ids.transpose(0, 1).reshape(-1),
                grads.transpose(0, 1).reshape(-1, grads.shape[-1]))
    return ids.reshape(-1), grads.reshape(-1, grads.shape[-1])


def scatter_add_ref(ids: torch.Tensor, grads: torch.Tensor, num_rows: int,
                    mode: str = "split") -> torch.Tensor:
    """Plain version of the kernel (same arguments, same result up to the
    order of the f32 additions)."""
    flat_ids, flat_g = _flat(ids, grads)
    flat_ids = flat_ids.long()
    keep = (flat_ids >= 0) & (flat_ids < num_rows)
    out = torch.zeros((num_rows, grads.shape[-1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, flat_ids[keep], round_mode(flat_g[keep], mode))


def _scatter_cuda(ids, grads, num_rows, mode):
    if grads.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the scatter kernel takes f32/bf16 grads, got "
                        f"{grads.dtype}")
    if ids.device != grads.device:
        raise ValueError("ids and grads must share one device")
    if ids.dim() > 2:                   # the order of the sum is free
        ids, grads = ids.reshape(-1), grads.reshape(-1, grads.shape[-1])
    if ids.dim() not in (1, 2) or grads.shape[:-1] != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} do not index grads "
                         f"{tuple(grads.shape)}")
    D = grads.shape[-1]
    rows, slots = (ids.shape[0], 1) if ids.dim() == 1 else ids.shape
    ids = ids.to(torch.int32).contiguous()
    grads = grads.contiguous()
    out = torch.empty((num_rows, D), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        _kernels.launch(
            *C_ENTRY, ids.data_ptr(), grads.data_ptr(),
            0 if grads.dtype == torch.float32 else 1, rows, slots, D,
            num_rows, _MODE_CODE[mode], out.data_ptr(),
            _kernels.stream_of(grads))
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
C_ENTRY = ("scatter_add", "ncf_scatter_add", "ppiiiiiipp")


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
