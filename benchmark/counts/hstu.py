"""HSTU's useful work in a training step, from the cell's shapes: the
mean causal pairs, positions and sequences a step of the batches the
traced slice ran (``drivers/train_hstu.py``), and the widths.  Never
from the program's counters, and never the kernel's padding: a head's
width counts at ``attention_dim`` and ``linear_dim`` (25), not at the 32
columns the kernel's tiles hold, and a pair only where j <= i.

Per step (``blocks`` of each): the attention's forward over every causal
pair and head, 2 FLOPs a multiply-add, a score of d_qk and a product with
V of d_v; its backward: the scores recomputed and the four products
(dV = A^T dO, dA = dO V^T, dQ = dS K, dK = dS^T Q); the linear layers
W_uvqk and W_o over every position; the sampled softmax's dot products
over every target and its 1 + negatives candidates.
"""

from __future__ import annotations

from benchmark.counts import Shapes

POS_BYTES = 8             # int64 timestamps and offsets
BF16, F32 = 2, 4
BUCKETS = 129


def attn_fwd(sh: Shapes):
    """(bytes, FLOPs) of one block's attention forward: Q, K, V read and O
    written once in bf16, the offsets, timestamps and bias tables read."""
    T, H = sh["positions"], sh["heads"]
    dqk, dv = sh["attention_dim"], sh["linear_dim"]
    tables = (2 * sh["max_len"] - 1 + BUCKETS) * F32
    nbytes = (T * H * (2 * dqk + dv) * BF16 + T * H * dv * BF16
              + (sh["sequences"] + 1 + T) * POS_BYTES + tables)
    return nbytes, sh["pairs"] * H * 2.0 * (dqk + dv)


def attn_bwd(sh: Shapes):
    """(bytes, FLOPs) of one block's attention backward: Q, K, V and dO
    read, dQ, dK, dV written in bf16, the bias tables read and their
    gradients written in f32; the recomputed scores and four products."""
    T, H = sh["positions"], sh["heads"]
    dqk, dv = sh["attention_dim"], sh["linear_dim"]
    tables = (2 * sh["max_len"] - 1 + BUCKETS) * F32
    nbytes = (T * H * (2 * dqk + 2 * dv) * BF16
              + T * H * (2 * dqk + dv) * BF16
              + (sh["sequences"] + 1 + T) * POS_BYTES + 2 * tables)
    return nbytes, sh["pairs"] * H * 2.0 * (3 * dqk + 2 * dv)


def linear_flops(sh: Shapes) -> float:
    """One block's W_uvqk and W_o forward over every position."""
    d, H = sh["item_dim"], sh["heads"]
    dqk, dv = sh["attention_dim"], sh["linear_dim"]
    return sh["positions"] * 2.0 * (d * 2 * H * (dv + dqk) + H * dv * d)


def train_step_flops(sh: Shapes) -> float:
    """Useful FLOPs of one step, the backward counted as twice the
    forward."""
    attn = sh["pairs"] * sh["heads"] * 2.0 * (sh["attention_dim"]
                                              + sh["linear_dim"])
    softmax = sh["targets"] * (1 + sh["negatives"]) * 2.0 * sh["item_dim"]
    return 3.0 * (sh["blocks"] * (attn + linear_flops(sh)) + softmax)
