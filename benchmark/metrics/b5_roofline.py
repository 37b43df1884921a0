"""``b5_roofline``: B5 (``ops/topk.py::topk_scores_streaming``,
``topk_streaming.cu``), its share of its roofline in a retrieval call."""

from __future__ import annotations

from typing import Tuple

from benchmark import counts
from benchmark.metrics.readers import roofline

KERNELS = ("seg_topk_tc_kernel", "merge_topk_kernel")
LAUNCH_COUNTER = "topk_scores_streaming"


def call(sh: counts.Shapes) -> Tuple[float, float, str]:
    """B5 on one call: it reads the f32 item vectors and the per-item bias
    once and the queries, and writes a value and an id (4 + 4 bytes) per
    slot of each user's top ``fetch``.  The f32 tables score through
    split-TF32 tensor cores, so the operations count at the TF32 peak."""
    B, I, D = sh["users_per_call"], sh["num_items"], sh["mf_dim"]
    nbytes = I * D * 4 + I * 4 + B * D * 4 + B * sh["fetch"] * 8
    return nbytes, counts.retrieve_flops(sh), "tf32"


def bound_s(sh: counts.Shapes) -> float:
    return counts.bound_s(*call(sh))


def read(slc, ctx):
    return roofline(slc, ctx, KERNELS, bound_s(ctx["shapes"]),
                    LAUNCH_COUNTER, 1)
