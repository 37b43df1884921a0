"""``mfu.train_hstu``: percent of the card's bf16 peak that HSTU's
training step reaches: the step's useful FLOPs (``counts/hstu.py``: the
attention's causal pairs, the linear layers and the sampled softmax's
dot products, the backward counted as twice the forward), from the
traced batches' lengths, over the window's time a step."""

from __future__ import annotations

from benchmark import counts
from benchmark.counts import hstu


def read(slc, ctx):
    sh = ctx["shapes"]
    if not sh.get("pairs"):
        return None
    return 100.0 * hstu.train_step_flops(sh) / ctx["window_call_s"] / \
        counts.PEAK_FLOP_S["bfloat16"]
