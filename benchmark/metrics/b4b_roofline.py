"""``b4b_roofline``: B4b (``ops/tower.py``, the fused tower's backward in
``fused_tower.cu``), its share of its roofline in a training step."""

from __future__ import annotations

from typing import Tuple

from benchmark import counts
from benchmark.metrics.readers import roofline

KERNELS = ("tower_bwd_kernel", "reduce_partials")
LAUNCH_COUNTER = "fused_tower_bwd"


def step(sh: counts.Shapes) -> Tuple[float, float, str]:
    """B4b, the tower's backward, once a step.  Its inputs are the tower's
    bf16 input rows and the f32 gradient of its output, and it writes the
    bf16 input gradient and the f32 parameter gradients; the parameters
    are read once.  Its work is the forward it must recompute (the
    activations are not among its inputs) and the two backward products
    of each layer (weights and inputs): 3 products, 2 FLOPs a
    multiply-add, at the configuration's bf16 peak."""
    n = counts.tower_rows(sh)
    d0 = sh["mlp_dim"] + sh["temporal_dim"]
    dims = [d0] + list(sh["hidden"])
    params = sum(a * b + 3 * b for a, b in zip(dims, dims[1:]))
    nbytes = n * d0 * 2 + n * dims[-1] * 4 + n * d0 * 2 + 2 * params * 4
    return nbytes, 3 * 2.0 * n * counts.tower_macs(sh), "bfloat16"


def bound_s(sh: counts.Shapes) -> float:
    return counts.bound_s(*step(sh))


def read(slc, ctx):
    return roofline(slc, ctx, KERNELS, bound_s(ctx["shapes"]),
                    LAUNCH_COUNTER, 1)
