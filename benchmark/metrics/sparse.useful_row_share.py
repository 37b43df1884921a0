"""``sparse.useful_row_share``: percent of the positions that the sparse
update goes through (``train/sparse.py``: the touched-row combine and
rowwise Adagrad, sinks included) that are distinct touched rows, from
the program's counters ``sparse_rows_touched`` and
``sparse_rows_processed`` over the slice (counted while a profiler
records).  Nothing to read where the program keeps no such counters or
the slice ran no sparse update."""

from __future__ import annotations


def read(slc, ctx):
    got = ctx["launches"]
    touched = got.get("sparse_rows_touched")
    processed = got.get("sparse_rows_processed")
    if touched is None or not processed:
        return None
    return 100.0 * touched / processed
