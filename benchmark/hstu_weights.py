"""Seeded HSTU weights, made on the device.

The layout is the port's parameter tree for ``hstu`` (the keys of
``models/hstu.py::init``, written out here so that the reference needs
nothing of the port), with the public code's initialisers: the item
table normal with std 0.02, the positions normal with std sqrt(1/d),
W_uvqk Xavier-uniform, W_o and b_o uniform in +-1/sqrt(fan in), the
relative bias tables normal with std 0.02.

As in ``weights.py``, each leaf draws from a generator of its own,
seeded from ``--seed`` and its path, and the item table in blocks of
``weights.TABLE_BLOCK`` rows, each from its own generator, so that a
check remakes any block alone.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from benchmark import weights
from benchmark.traffic.generate import sub_seed

BUCKETS = 129


def layout(m) -> Dict[str, Any]:
    """Leaves ``(kind, shape, scale)``: kind ``table`` (normal, in
    blocks), ``normal`` or ``uniform`` (scale: the std or the bound)."""
    d, H = m.item_embedding_dim, m.num_heads
    dqk, dv, N = m.attention_dim, m.linear_dim, m.max_sequence_length
    width = 2 * H * (dv + dqk)
    blocks = [{
        "uvqk": ("uniform", (d, width), math.sqrt(6.0 / (d + width))),
        "o": {"w": ("uniform", (H * dv, d), 1.0 / math.sqrt(H * dv)),
              "b": ("uniform", (d,), 1.0 / math.sqrt(H * dv))},
        "w_pos": ("normal", (2 * N - 1,), 0.02),
        "w_ts": ("normal", (BUCKETS,), 0.02)} for _ in range(m.num_blocks)]
    return {"item_emb": ("table", (m.num_items, d), 0.02),
            "pos_emb": ("normal", (N, d), math.sqrt(1.0 / d)),
            "blocks": blocks}


def table_block(seed: int, path: str, spec, block: int, device,
                out=None) -> torch.Tensor:
    """Rows ``[block * TABLE_BLOCK, ...)`` of table ``path``."""
    _, (rows, width), std = spec
    lo = block * weights.TABLE_BLOCK
    n = min(weights.TABLE_BLOCK, rows - lo)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, f"hstu/{path}/{block}"))
    if out is None:
        out = torch.empty((n, width), device=device)
    torch.randn((n, width), generator=gen, device=device, out=out)
    return out.mul_(std)


def leaf_maker(seed: int, device):
    """``make(path, spec)``: the seeded leaf at ``path`` of ``layout``."""
    def make(path, spec):
        kind, shape, scale = spec
        if kind == "table":
            t = torch.empty(shape, device=device)
            for b in range(weights.table_blocks(shape)):
                lo = b * weights.TABLE_BLOCK
                table_block(seed, path, spec, b, device,
                            out=t[lo:lo + weights.TABLE_BLOCK])
            return t
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, f"hstu/{path}"))
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=device) * scale
        u = torch.rand(shape, generator=gen, device=device)
        return u * (2.0 * scale) - scale
    return make


def make_params(m, seed: int, device) -> Dict[str, Any]:
    """The seeded weights of model config ``m`` on ``device``, f32."""
    return weights._map(layout(m), leaf_maker(seed, device))
