"""Philox4x32-10 (Salmon et al., SC'11) and the fused tower's dropout
words, written out again from the port's stated rule (``ops/tower.py``):
layer ``l``'s activation ``[rows, cols]`` takes key ``(seed, l)`` and
counter ``(row, col // 4, 0, 0)``; element ``(row, col)`` takes word
``col % 4`` and is kept iff it is below ``min(int(keep * 2**32),
2**32 - 1)``.  The reference draws the seed as the port does (one int32
from the step's generator) and so keeps the same elements.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b``, ``a`` split into 16-bit
    halves so that every partial product fits in int64."""
    x = b * (a >> 16)
    y = b * (a & 0xFFFF)
    s = x + (y >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (y & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, layer: int, rows: int, cols: int,
              rate: float) -> torch.Tensor:
    """bool [rows, cols]: the elements layer ``layer`` keeps."""
    dev = seed.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    q = torch.arange(-(-cols // 4), dtype=torch.int64, device=dev)[None, :]
    r, q = torch.broadcast_tensors(r, q)
    zero = torch.zeros_like(r)
    k0 = seed.reshape(()).to(torch.int64) & _MASK32
    k1 = torch.full((), layer, dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32(r, q, zero, zero, k0, k1), dim=-1)
    words = words.reshape(rows, -1)[:, :cols]
    return words < min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
