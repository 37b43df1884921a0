"""The benchmark's yardstick, the part that several metrics share: the
card's peaks, the roofline bound, and the useful operations of a
retrieval call and of a training step, computed from the shapes of the
cell (never from what a kernel happens to do).  Each kernel's own count
of bytes and operations sits beside its metric
(``metrics/<kernel>_roofline.py``).

A roofline bound is the larger of two times: the operation's bytes
(every input read once, every output written once) at the card's
memory bandwidth, and its useful operations at the peak of the
precision the configuration states.  Copied from ``chip_smoke.py``'s
``_bound`` arithmetic, with one change: B4b's work is counted as the
products the backward needs at the configuration's bf16, not as the
kernel's three split-TF32 products.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without
sparsity), at its full 700 W.
"""

from __future__ import annotations

from typing import Dict

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
               "int8": 1979e12}

Shapes = Dict[str, object]


def bound_s(nbytes: float, flops: float, peak: str) -> float:
    """The least time the card can take: bytes at the bandwidth or
    operations at ``peak``, whichever is longer."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[peak])


# ------------------------------------------------------------ retrieval

def retrieve_flops(sh: Shapes) -> float:
    """Useful FLOPs of one retrieval call: every user's query against
    every item, 2 per multiply-add (the bias add and the selection are
    not counted)."""
    return 2.0 * sh["users_per_call"] * sh["num_items"] * sh["mf_dim"]


# ------------------------------------------------------------- training

def tower_macs(sh: Shapes) -> int:
    """Multiply-adds of one row through the MLP tower's dense layers."""
    dims = [sh["mlp_dim"] + sh["temporal_dim"]] + list(sh["hidden"])
    return sum(a * b for a, b in zip(dims, dims[1:]))


def tower_rows(sh: Shapes) -> int:
    """Rows the tower runs on: under ``joint`` the MLP path is shared by
    a row's 1 + negatives slots (``utils/config.py``'s candidate_mode),
    so one per row; otherwise one per slot."""
    return sh["batch"] * (1 if sh["joint"] else sh["slots"])


def train_step_flops(sh: Shapes) -> float:
    """Useful FLOPs of one training step, 2 a multiply-add: the forward of
    every dense layer over the rows that layer runs on by the model's
    equations, with the backward counted as twice the forward.  Lookups,
    LayerNorms, the attention's scores and the optimizer are left out.

    Per step: the category hierarchy's value and output projections
    (d x d each) over every item (precompute branch) or every occurrence
    (precompute off); the candidate attention's query and output
    projections over the B rows and its key and value projections over
    the B*S slots; the tower (``tower_rows``); the MF head (mf_dim x 1)
    over the slots, the MLP head (h x 1) over the tower's rows and the
    fusion (2 x 1) over the slots."""
    B, S = sh["batch"], sh["slots"]
    d = sh["mlp_dim"]
    hier_rows = B * S if sh["sparse"] or not sh["precompute"] \
        else sh["num_items"]
    n_tower = tower_rows(sh)
    macs = (hier_rows * 2 * d * d
            + B * 2 * d * d + B * S * 2 * d * d
            + n_tower * tower_macs(sh)
            + B * S * sh["mf_dim"] + n_tower * sh["hidden"][-1]
            + B * S * 2)
    return 3 * 2.0 * macs
