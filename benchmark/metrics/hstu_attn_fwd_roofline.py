"""``hstu_attn_fwd_roofline``: HSTU's attention forward
(``ops/hstu_attention.py``, ``hstu_attention.cu``), its share of its
roofline in a training step: one launch a block, its work counted from
the traced batches' lengths (``counts/hstu.py::attn_fwd``) at the bf16
peak."""

from __future__ import annotations

from benchmark import counts
from benchmark.counts import hstu
from benchmark.metrics.readers import roofline

KERNELS = ("hstu_attn_fwd_kernel",)
LAUNCH_COUNTER = "hstu_attn_fwd"


def bound_s(sh: counts.Shapes) -> float:
    return sh["blocks"] * counts.bound_s(*hstu.attn_fwd(sh), "bfloat16")


def read(slc, ctx):
    sh = ctx["shapes"]
    if not sh.get("pairs"):
        return None
    return roofline(slc, ctx, KERNELS, bound_s(sh), LAUNCH_COUNTER,
                    sh["blocks"])
