"""``b2_roofline``: B2 (``ops/scatter.py::onehot_scatter_add``,
``scatter_add.cu``), the summed bound of a training step's launches over
their device time."""

from __future__ import annotations

from typing import Dict, List

from benchmark import counts
from benchmark.metrics.readers import roofline

KERNELS = ("group_hist_kernel", "group_colscan_kernel", "group_place_kernel",
           "group_csr_kernel", "group_longs_kernel", "scatter_small_kernel",
           "scatter_rows_kernel")
LAUNCH_COUNTER = "onehot_scatter_add"


def step_launches(sh: counts.Shapes) -> List[Dict[str, int]]:
    """The B2 launches of one training step, each as {ids, d, rows,
    id_bytes, grad_bytes}: ``ids`` rows of gradient of width ``d`` added
    into an f32 ``[rows, d]`` result.

    Precompute branch (vocabulary under 4x the batch's occurrences,
    ``models/advanced_ncf.py::_use_vocab_precompute``): the gradients of
    the bf16 derived tables, users [U, 2d] from B ids and items [I, 2d]
    from B*S ids; the category hierarchy's department and category
    tables (f32 [*, d]) from one id per item.  Sparse step (precompute
    off): the hierarchy's tables from one id per occurrence, and the
    combine of the injected rows' f32 gradients into one total per
    occurrence (``train/sparse.py::combine_duplicate_rows``: two int64
    ids a position, out [n, 2d]) for the users and for the items.  Both:
    the three learned temporal tables [24|7|12, dt] from B ids each, the
    backward of the fused lookup-sum B3."""
    B, S = sh["batch"], sh["slots"]
    d, dt = sh["mlp_dim"], sh["temporal_dim"]
    w = sh["mf_dim"] + sh["mlp_dim"]
    out = []
    if sh["sparse"]:
        for n in (B, B * S):
            out.append({"ids": n, "d": w, "rows": n, "id_bytes": 16,
                        "grad_bytes": 4})
        hier_ids = B * S
    else:
        out.append({"ids": B, "d": w, "rows": sh["num_users"],
                    "id_bytes": 4, "grad_bytes": 2})
        out.append({"ids": B * S, "d": w, "rows": sh["num_items"],
                    "id_bytes": 4, "grad_bytes": 2})
        hier_ids = sh["num_items"]
    for rows in (sh["num_departments"], sh["num_categories"]):
        out.append({"ids": hier_ids, "d": d, "rows": rows, "id_bytes": 4,
                    "grad_bytes": 4})
    for rows in (24, 7, 12):
        out.append({"ids": B, "d": dt, "rows": rows, "id_bytes": 4,
                    "grad_bytes": 4})
    return out


def bound_s(sh: counts.Shapes) -> float:
    """The summed bound of a step's launches: each reads its ids and
    gradient rows once and writes its f32 result once (adds are not the
    limit: one per element read)."""
    total = 0.0
    for x in step_launches(sh):
        nbytes = (x["ids"] * (x["id_bytes"] + x["d"] * x["grad_bytes"])
                  + x["rows"] * x["d"] * 4)
        total += counts.bound_s(nbytes, x["ids"] * x["d"], "float32")
    return total


def read(slc, ctx):
    sh = ctx["shapes"]
    return roofline(slc, ctx, KERNELS, bound_s(sh), LAUNCH_COUNTER,
                    len(step_launches(sh)))
