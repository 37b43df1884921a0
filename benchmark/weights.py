"""Seeded AdvancedNCF weights, made on the device.

The layout is the port's parameter tree for ``advanced_ncf`` without the
sequence path (the keys of ``models/advanced_ncf.py::init``, written out
here so that the reference needs nothing of the port), and the
distributions are the model's initialisers: tables N(0, 0.1), dense
layers uniform in +-1/sqrt(fan in), LayerNorm scale 1 and bias 0.

Each leaf draws from a generator of its own, seeded from ``--seed`` and
the leaf's path, and a table draws in blocks of ``TABLE_BLOCK`` rows, each
from its own generator: so any block of any leaf can be made again
alone (``table_block``), which is how a check recomputes the rows a run
started from without holding a second copy of a 12M-row table.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from benchmark.traffic.generate import sub_seed

TABLE_BLOCK = 1 << 20
TABLE_SCALE = 0.1


def layout(m) -> Dict[str, Any]:
    """The parameter tree of shapes for model config ``m`` (a
    ``ModelConfig`` or anything with its fields): leaves are
    ``(kind, shape)`` with kind ``table``, ``w``, ``b`` (with the fan in),
    ``ones`` or ``zeros``."""
    if getattr(m, "use_sequence", False):
        raise ValueError("the benchmark's weights cover AdvancedNCF without "
                         "the sequence path")

    def dense(i, o):
        return {"w": ("w", (i, o), i), "b": ("b", (o,), i)}

    def norm(d):
        return {"scale": ("ones", (d,)), "bias": ("zeros", (d,))}

    def mha(d):
        return {k: dense(d, d) for k in ("q", "k", "v", "o")}

    D = m.mlp_dim
    width = m.mf_dim + m.mlp_dim
    tower, cur = [], D + m.temporal_dim
    for h in m.mlp_hidden_dims:
        tower.append({"dense": dense(cur, h), "norm": norm(h)})
        cur = h
    out = {
        "user_emb": ("table", (m.num_users, width)),
        "item_emb": ("table", (m.num_items, width)),
        "mf_norm": norm(m.mf_dim),
        "mlp_norm": norm(D),
        "attn": mha(D),
        "mlp": tower,
        "mf_out": dense(m.mf_dim, 1),
        "mlp_out": dense(m.mlp_hidden_dims[-1], 1),
        "final": dense(2, 1),
        "temporal": {k: ("table", (n, m.temporal_dim))
                     for k, n in (("hour", 24), ("day", 7), ("month", 12))},
        "temporal_proj": dense(m.temporal_dim, m.mf_dim),
    }
    if getattr(m, "use_category", True):
        out["category"] = {"dept": ("table", (m.num_departments, D)),
                           "cat": ("table", (m.num_categories, D)),
                           "attn": mha(D), "norm": norm(D)}
    return out


def leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts and lists, in the order of the
    port's ``tree_leaves`` (dict keys as stored, lists in order)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _map(tree, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def table_block(seed: int, path: str, shape, block: int, device,
                out=None) -> torch.Tensor:
    """Rows ``[block * TABLE_BLOCK, ...)`` of table ``path`` (written
    into ``out`` when given)."""
    rows, width = shape
    lo = block * TABLE_BLOCK
    n = min(TABLE_BLOCK, rows - lo)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, f"weights/{path}/{block}"))
    if out is None:
        out = torch.empty((n, width), device=device)
    torch.randn((n, width), generator=gen, device=device, out=out)
    return out.mul_(TABLE_SCALE)


def table_blocks(shape) -> int:
    return -(-shape[0] // TABLE_BLOCK)


def leaf_maker(seed: int, device):
    """``make(path, spec)``: the seeded leaf at ``path`` of ``layout``."""
    def make(path, spec):
        kind, shape = spec[0], spec[1]
        if kind == "table":
            t = torch.empty(shape, device=device)
            for b in range(table_blocks(shape)):
                lo = b * TABLE_BLOCK
                table_block(seed, path, shape, b, device,
                            out=t[lo:lo + TABLE_BLOCK])
            return t
        if kind == "ones":
            return torch.ones(shape, device=device)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        bound = 1.0 / float(spec[2]) ** 0.5
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, f"weights/{path}"))
        u = torch.rand(shape, generator=gen, device=device)
        return u * (2.0 * bound) - bound
    return make


def make_params(m, seed: int, device) -> Dict[str, Any]:
    """The seeded weights of model config ``m`` on ``device``, f32."""
    return _map(layout(m), leaf_maker(seed, device))
