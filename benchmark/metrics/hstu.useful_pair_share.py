"""``hstu.useful_pair_share``: percent of the score entries that HSTU's
attention forward computes (its launch plan's 64 x 64 tiles, padding and
masked entries included) that are causal pairs of real positions, from
the program's counters ``hstu_pairs_useful`` and ``hstu_pairs_computed``
over the slice (counted while a profiler records).  Nothing to read
where the program keeps no such counters."""

from __future__ import annotations


def read(slc, ctx):
    got = ctx["launches"]
    useful = got.get("hstu_pairs_useful")
    computed = got.get("hstu_pairs_computed")
    if useful is None or not computed:
        return None
    return 100.0 * useful / computed
