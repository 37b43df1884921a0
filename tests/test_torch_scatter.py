"""Port parity for the scatter-add kernel B2 and the embedding lookup's
backward: the plain version against the sequential ``np.add.at`` in f32
(bit for bit) and against the JAX Pallas kernel
(``onehot_scatter_add(..., interpret=True)``) in each rounding mode, the
kernel's grouping (its counting sort, and the route above ``ROW_LIMIT``)
replayed in NumPy and held to ``np.argsort(kind="stable")``, the
pre-grouped entry and the sparse combine through it, which routes sort,
the backward's routing against ``ncf_tpu.ops.embedding``'s decision, and
B7's backward.

Tolerances: against ``np.add.at`` in f32 on the rounded values, equal bit
for bit (the port fixes that order of the adds).  Relative to the
per-element magnitude sum ``sum |g|``: against the JAX kernel, every mode
within 2e-6 (both round each element the same way first and then add in
f32; the one-hot matmuls add in another order).  Against XLA's exact f32
scatter, ``split`` adds up to 2^-18 of each element (the residual of its
two bf16 terms) and ``bf16`` up to 2^-9 (tested at 2^-8).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.ops import embedding as jemb  # noqa: E402
from ncf_tpu.ops import pallas_scatter as jscatter  # noqa: E402
from ncf_tpu_torch.ops import embedding as temb  # noqa: E402
from ncf_tpu_torch.ops import gather as tgather  # noqa: E402
from ncf_tpu_torch.ops import scatter as tscatter  # noqa: E402

RTOL = {"split": 2e-6, "f32": 2e-6, "bf16": 2e-6}


def _ids_grads(shape, rows, d, seed, bf16=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, shape).astype(np.int32)
    flat = ids.reshape(-1)
    flat[:7] = [-1, rows, rows + 5, -3, 0, rows - 1, rows - 1]   # padding
    g = rng.normal(size=shape + (d,)).astype(np.float32)
    if bf16:
        g = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return ids, g


def _magnitude(ids, g, rows):
    flat = ids.reshape(-1)
    keep = (flat >= 0) & (flat < rows)
    out = np.zeros((rows, g.shape[-1]), np.float64)
    np.add.at(out, flat[keep], np.abs(g.reshape(-1, g.shape[-1])[keep]))
    return out


@pytest.mark.parametrize("mode", ("split", "bf16", "f32"))
@pytest.mark.parametrize("shape,rows,d", [((2500,), 300, 16),
                                          ((700, 5), 130, 8),
                                          ((4096,), 24, 32)])
@pytest.mark.parametrize("grad_dtype", ("float32", "bfloat16"))
def test_plain_b2_matches_pallas_interpret(mode, shape, rows, d, grad_dtype):
    bf16 = grad_dtype == "bfloat16"
    ids, g = _ids_grads(shape, rows, d, seed=rows + d, bf16=bf16)
    jg = jnp.asarray(g, jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(jscatter.onehot_scatter_add(
        jnp.asarray(ids), jg, rows, mode=mode, interpret=True))
    tg = torch.from_numpy(g).to(torch.bfloat16 if bf16 else torch.float32)
    got = tscatter.onehot_scatter_add(torch.from_numpy(ids), tg, rows,
                                      mode=mode)
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    tol = RTOL[mode] * _magnitude(ids, g, rows) + 1e-30
    assert (np.abs(got.numpy() - want) <= tol).all()


def _rounded(g, mode):
    """round_mode in NumPy (bf16 through ml_dtypes, round to nearest even)."""
    g = np.asarray(g, np.float32)
    if mode == "f32":
        return g
    hi = g.astype(jnp.bfloat16).astype(np.float32)
    if mode == "bf16":
        return hi
    return hi + (g - hi).astype(jnp.bfloat16).astype(np.float32)


def _sequential(ids, g, rows, mode):
    """np.add.at in f32 over the reference's flattening: each element the
    sequential sum of its rounded values in flattened order."""
    flat = (ids.T if ids.ndim == 2 else ids).reshape(-1)
    fg = (g.transpose(1, 0, 2) if ids.ndim == 2 else g).reshape(
        -1, g.shape[-1])
    keep = (flat >= 0) & (flat < rows)
    out = np.zeros((rows, g.shape[-1]), np.float32)
    np.add.at(out, flat[keep], _rounded(fg[keep], mode))
    return out


def _case(name, seed):
    """(ids, f32 grads, rows) of the named shape."""
    rng = np.random.default_rng(seed)
    if name == "1d":
        ids, rows, d = rng.integers(-2, 302, (2500,)), 300, 16
    elif name == "2d":
        ids, rows, d = rng.integers(-2, 132, (700, 5)), 130, 8
    elif name == "3d":
        ids, rows, d = rng.integers(0, 40, (30, 4, 3)), 40, 12
    elif name == "repeated":              # one id holds most positions
        ids, rows, d = rng.integers(0, 50, (3000,)), 50, 33
        ids[rng.random(3000) < 0.9] = 17
    elif name == "zipf":                  # a popularity skew, 2-D
        ids, rows, d = rng.zipf(1.2, (600, 5)) - 1, 500, 16
    elif name == "out_of_range":
        ids, rows, d = rng.integers(-50, 0, (400,)), 20, 8
        ids[::2] = 20 + rng.integers(0, 9, 200)
    else:                                 # empty
        ids, rows, d = np.zeros((0,), np.int64), 9, 4
    ids = ids.astype(np.int32)
    g = rng.normal(size=ids.shape + (d,)).astype(np.float32)
    g.reshape(-1, d)[:2] = -0.0           # -0.0 + 0.0 is +0.0
    g.reshape(-1, d)[2:5] *= 1e-39        # subnormals
    return ids, g, rows


_CASES = ("1d", "2d", "3d", "repeated", "zipf", "out_of_range", "empty")


@pytest.mark.parametrize("mode", ("split", "bf16", "f32"))
@pytest.mark.parametrize("grad_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", _CASES)
def test_plain_b2_is_the_sequential_f32_sum(mode, grad_dtype, name):
    ids, g, rows = _case(name, seed=len(name))
    if grad_dtype == "bfloat16":
        g = g.astype(jnp.bfloat16).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, grad_dtype))
    got = tscatter.onehot_scatter_add(torch.from_numpy(ids), tg, rows,
                                      mode=mode)
    want = _sequential(ids, g, rows, mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _flat_rows(ids):
    """(flattened ids, each flattened position's row of grads, rows,
    slots): 2-D ids slot-major, others row-major."""
    if ids.ndim == 2:
        rows, slots = ids.shape
        f = np.arange(ids.size)
        e = (f % rows) * slots + f // rows if rows else f
    else:
        rows, slots = ids.size, 1
        e = np.arange(ids.size)
    return ids.reshape(-1)[e], e, rows, slots


def _counting_model(ids, R):
    """``csrc/scatter_add.cu``'s counting route replayed in NumPy, with the
    wrapper's constants: chunk counts (``group_hist_kernel``), each row's
    positions before a chunk (``group_colscan_kernel``), then per chunk
    the rows' starts, a 16-bit count a (warp, row), the prefix over warps,
    and each position placed after the equal ids of its warp's lower lanes
    (``group_place_kernel``).  Returns (CSR start [R + 1], each sorted
    position's row of grads, its row, the rows of long runs)."""
    keys_f, e_f, rows, slots = _flat_rows(ids)
    n = keys_f.size
    chunk, nch = tscatter.chunk_size(n), tscatter.num_chunks(n)
    per = chunk // tscatter.WARPS
    assert chunk % tscatter.WARPS == 0 and per % 32 == 0

    def slabs(c, w):
        lo = c * chunk + w * per
        hi = min(lo + per, n)
        for f0 in range(lo, hi, 32):
            f = np.arange(f0, f0 + 32)
            ok = f < hi
            k = np.where(ok, keys_f[np.minimum(f, n - 1)] if n else -1, -1)
            k = np.where((k >= 0) & (k < R), k, -1)
            yield k, np.where(ok, e_f[np.minimum(f, n - 1)] if n else 0, 0)

    def groups(k):              # a slab's equal ids: {id: lanes}, in order
        return {int(v): np.flatnonzero(k == v) for v in np.unique(k[k >= 0])}

    hist = np.zeros((nch, R), np.int64)
    for c in range(nch):
        for w in range(tscatter.WARPS):
            for k, _ in slabs(c, w):
                for v, lanes in groups(k).items():
                    hist[c, v] += lanes.size
    before = np.cumsum(hist, 0) - hist                  # colscan
    tot = np.concatenate([hist.sum(0), [0]])            # and row R
    # each block of 256 rows scans its own and adds the sums of the
    # blocks before it (published, read back)
    threads = 32 * tscatter.WARPS
    blocks = np.arange(R + 1) // threads
    local = np.zeros(R + 1, np.int64)
    for b in range(blocks[-1] + 1):
        rows_b = np.flatnonzero(blocks == b)
        local[rows_b] = np.cumsum(tot[rows_b]) - tot[rows_b]
    bsum = np.bincount(blocks, weights=tot).astype(np.int64)
    boff = np.cumsum(bsum) - bsum
    start = local + boff[blocks]
    tot = tot[:R]
    kept = int(start[-1])
    pos_e = np.full(kept, -1, np.int64)
    row_of = np.full(kept, -1, np.int64)
    for c in range(nch):
        cnt = np.zeros((tscatter.WARPS, R), np.int64)
        for w in range(tscatter.WARPS):
            for k, _ in slabs(c, w):
                for v, lanes in groups(k).items():
                    cnt[w, v] += lanes.size
        assert cnt.sum(0).max(initial=0) < 2 ** 16        # 16-bit counts
        cnt = np.cumsum(cnt, 0) - cnt                     # earlier warps
        base = start[:R] + before[c]
        for w in range(tscatter.WARPS):
            for k, e in slabs(c, w):
                for v, lanes in groups(k).items():
                    dest = base[v] + cnt[w, v] + np.arange(lanes.size)
                    assert (pos_e[dest] == -1).all()
                    pos_e[dest], row_of[dest] = e[lanes], v
                    cnt[w, v] += lanes.size
    longs = set(np.flatnonzero(tot > tscatter.LONG_RUN).tolist())
    return start, pos_e, row_of, longs


def _small_model(ids, R):
    """The small tables' route (``scatter_small_kernel``): for each row,
    each warp's contiguous part of the positions, a ballot a slab of 32,
    the positions whose id is the row listed after the earlier warps' and
    the lower lanes'.  Returns each row's list of grads rows."""
    keys_f, e_f, _, _ = _flat_rows(ids)
    n = keys_f.size
    threads = 32 * tscatter.WARPS
    per = -(-n // threads) * 32
    runs = []
    for r in range(R):
        parts = []
        for w in range(tscatter.WARPS):
            lo, hi = min(w * per, n), min(w * per + per, n)
            part = []
            for f0 in range(lo, hi, 32):
                f = np.arange(f0, min(f0 + 32, hi))
                hit = keys_f[f] == r                  # the slab's ballot
                part.extend(e_f[f[hit]].tolist())     # lower lanes first
            parts.append(part)
        runs.append(sum(parts, []))
    return runs


@pytest.mark.parametrize("name", ("hour", "day", "dept", "out_of_range",
                                  "empty", "small_2d", "repeated"))
def test_small_grouping_is_a_stable_argsort(name):
    """The small tables' route (up to ``SMALL_ROWS`` rows): each row's
    list in the order of ``np.argsort(kind="stable")``."""
    ids, R = _model_ids(name)
    assert tscatter.small_route(R, ids.size)
    runs = _small_model(ids, R)
    want_e, _, want_start = _stable_order(ids, R)
    for r in range(R):
        assert runs[r] == want_e[want_start[r]:want_start[r + 1]].tolist()


def _sorted_model(ids, R, seed=0):
    """The other route: ``torch.sort`` of the flattened ids, then
    ``group_csr_kernel`` (each row's start and end written where its run
    begins and ends, over scratch that starts as garbage),
    ``group_longs_kernel``, and the adds' test of a row's start.  Returns
    (each row's run as (start, end), each sorted position's row of grads,
    its row, the rows of long runs)."""
    keys_f, e_f, rows, slots = _flat_rows(ids)
    n = keys_f.size
    sk, perm = torch.sort(torch.from_numpy(keys_f), stable=True)
    sk, perm = sk.numpy(), perm.numpy()
    row_of = np.where(sk < 0, -1, np.where(sk >= R, R, sk))
    f = perm
    pos_e = f if slots == 1 else (f % rows) * slots + f // rows
    rng = np.random.default_rng(seed)
    start = rng.integers(-2 ** 31, 2 ** 31, R)       # torch.empty: garbage
    end = rng.integers(-2 ** 31, 2 ** 31, R)
    start[rng.integers(0, R, 5)] = rng.integers(0, max(n, 1), 5)
    for p in range(n):
        k = row_of[p]
        if 0 <= k < R:
            if p == 0 or row_of[p - 1] != k:
                start[k] = p
            if p == n - 1 or row_of[p + 1] != k:
                end[k] = p + 1
    longs = set()
    for p in range(n):
        k = row_of[p]
        if (0 <= k < R and (p == 0 or row_of[p - 1] != k)
                and p + tscatter.LONG_RUN < n
                and row_of[p + tscatter.LONG_RUN] == k):
            longs.add(int(k))
    runs = []
    for r in range(R):                       # scatter_rows_kernel's test
        s0 = int(start[r])
        ok = 0 <= s0 < n and row_of[s0] == r
        runs.append((s0, int(end[r])) if ok else (0, 0))
    return runs, pos_e, row_of, longs


# small step shapes: the temporal tables, the vocabulary-level tables, the
# user and item tables at a small batch, chunk edges, long runs
_STEP_CASES = {"hour": ((4096,), 24), "day": ((4096,), 7),
               "dept": ((3706,), 9), "user": ((2048,), 6040),
               "item": ((1024, 5), 3706), "ragged": ((3 * 2048 + 77,), 30),
               "one_id": ((600, 5), 3706), "at_limit": ((4096,), 11264),
               "small_2d": ((700, 5), 40)}


def _model_ids(name):
    if name in _STEP_CASES:
        shape, rows = _STEP_CASES[name]
        rng = np.random.default_rng(len(name))
        ids = rng.integers(-2, rows + 2, shape)
        if name == "one_id":
            ids[:] = 1234
        return ids.astype(np.int32), rows
    ids, _, rows = _case(name, seed=7)
    return ids, rows


def _stable_order(ids, R):
    """np.argsort(kind="stable") of the flattened ids in range: each
    sorted position's row of grads and row, and the CSR of runs."""
    keys_f, e_f, _, _ = _flat_rows(ids)
    kept = np.flatnonzero((keys_f >= 0) & (keys_f < R))
    order = kept[np.argsort(keys_f[kept], kind="stable")]
    rows = keys_f[order]
    return e_f[order], rows, np.searchsorted(rows, np.arange(R + 1))


@pytest.mark.parametrize("name", _CASES + tuple(_STEP_CASES))
def test_counting_grouping_is_a_stable_argsort(name):
    """The kernel's index arithmetic for tables up to ``ROW_LIMIT`` rows
    equals ``np.argsort(kind="stable")`` of the flattened ids."""
    ids, R = _model_ids(name)
    assert tscatter.counting_route(R, ids.size)
    start, pos_e, row_of, longs = _counting_model(ids, R)
    want_e, want_rows, want_start = _stable_order(ids, R)
    assert np.array_equal(start, want_start)
    assert np.array_equal(pos_e, want_e)
    assert np.array_equal(row_of, want_rows)
    assert longs == {r for r in range(R) if np.diff(want_start)[r]
                     > tscatter.LONG_RUN}


def test_counting_grouping_grows_its_chunks():
    """Past ``CHUNK * MAX_CHUNKS`` positions a chunk grows (a multiple of
    the block's threads), so there are at most ``MAX_CHUNKS`` blocks."""
    n = tscatter.CHUNK * tscatter.MAX_CHUNKS + 1000
    assert tscatter.chunk_size(n) % 256 == 0
    assert tscatter.num_chunks(n) <= tscatter.MAX_CHUNKS
    assert tscatter.chunk_size(n) * tscatter.num_chunks(n) >= n
    assert tscatter.chunk_size(tscatter.MAX_CHUNKS
                               * tscatter.MAX_CHUNK) == tscatter.MAX_CHUNK
    assert not tscatter.counting_route(3, tscatter.MAX_CHUNKS
                                       * tscatter.MAX_CHUNK + 1)
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 8, n).astype(np.int32)
    start, pos_e, row_of, _ = _counting_model(ids, 7)
    want_e, want_rows, want_start = _stable_order(ids, 7)
    assert np.array_equal(start, want_start)
    assert np.array_equal(pos_e, want_e) and np.array_equal(row_of, want_rows)


@pytest.mark.parametrize("name", _CASES + ("item", "one_id", "above_limit"))
def test_sorted_grouping_rejects_rows_no_id_names(name):
    """The route above ``ROW_LIMIT`` (and the caller's grouping): rows no
    id names keep garbage starts, which the adds reject; every other row
    gets its run."""
    if name == "above_limit":
        rng = np.random.default_rng(3)
        ids, R = rng.integers(-2, 11267, (900, 5)).astype(np.int32), 11265
        assert not tscatter.counting_route(R, ids.size)
    else:
        ids, R = _model_ids(name)
    runs, pos_e, row_of, longs = _sorted_model(ids, R)
    want_e, want_rows, want_start = _stable_order(ids, R)
    lo = int(np.searchsorted(row_of, 0))
    got_e = np.concatenate([pos_e[s:t] for s, t in runs] + [[]])
    assert np.array_equal(got_e.astype(np.int64), want_e)
    assert [t - s for s, t in runs] == np.diff(want_start).tolist()
    assert all(s - lo == want_start[r] for r, (s, t) in enumerate(runs)
               if t > s)
    assert longs == {r for r in range(R) if np.diff(want_start)[r]
                     > tscatter.LONG_RUN}


@pytest.mark.parametrize("name", _CASES + ("hour", "item", "one_id"))
def test_kernel_bookkeeping_replays_the_plain_order(name):
    """What the kernel does with its grouping, replayed in NumPy: for each
    row, its run of sorted positions in order, each position's row of
    grads, summed from 0.0 in f32."""
    ids, rows = _model_ids(name)
    rng = np.random.default_rng(5)
    g = rng.normal(size=ids.shape + (6,)).astype(np.float32)
    start, pos_e, _, _ = _counting_model(ids, rows)
    g2 = _rounded(g.reshape(-1, g.shape[-1]), "split")
    out = np.zeros((rows, g.shape[-1]), np.float32)
    for i in range(rows):
        for e in pos_e[start[i]:start[i + 1]]:
            out[i] += g2[e]
    want = tscatter.scatter_add_ref(torch.from_numpy(ids),
                                    torch.from_numpy(g), rows, "split")
    assert np.array_equal(out.view(np.int32), want.numpy().view(np.int32))


def test_kernel_constants_match_the_wrapper():
    """``ops/scatter.py``'s copies of the kernel's constants, read from
    ``csrc/scatter_add.cu``."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tscatter.__file__), "csrc",
                            "scatter_add.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kCountRowLimit"] == tscatter.ROW_LIMIT
    assert const["kChunk"] == tscatter.CHUNK
    assert const["kMaxChunk"] == tscatter.MAX_CHUNK
    assert const["kMaxChunks"] == tscatter.MAX_CHUNKS
    assert const["kThreads"] // 32 == tscatter.WARPS
    assert const["kLongRun"] == tscatter.LONG_RUN
    assert const["kSmallRows"] == tscatter.SMALL_ROWS
    assert const["kSmallN"] == tscatter.SMALL_N
    # scatter_small_kernel's shared memory: its list and the ring
    assert 4 * tscatter.SMALL_N + 7 * 32 * 32 * 4 <= 232448 - 64
    # group_place_kernel's shared memory: 16-bit counts a (warp, row) and
    # an int a row, within the 227 KB a block may have
    assert 20 * tscatter.ROW_LIMIT <= 232448 - 64
    assert tscatter.MAX_CHUNK < 2 ** 16 and tscatter.MAX_CHUNK % 256 == 0


@pytest.mark.parametrize("mode", ("f32", "split"))
@pytest.mark.parametrize("n,rows", [(2500, 300), (4096, 7), (1, 3)])
def test_grouped_entry_equals_b2_on_its_ids(mode, n, rows):
    """``scatter_add_grouped`` given ``torch.sort``'s grouping equals
    ``onehot_scatter_add`` on the ids bit for bit, out-of-range rows
    dropped alike."""
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(rng.integers(-1, rows + 1, n))
    g = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    keys, order = torch.sort(ids, stable=True)
    got = tscatter.scatter_add_grouped(order, keys, g, rows, mode=mode)
    want = tscatter.onehot_scatter_add(ids, g, rows, mode=mode)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy().view(np.int32),
                          _sequential(ids.numpy(), g.numpy(), rows,
                                      mode).view(np.int32))
    with pytest.raises(ValueError):
        tscatter.scatter_add_grouped(order[1:], keys, g, rows)


def test_sparse_combine_keeps_the_parents_bits():
    """``combine_duplicate_rows`` through the grouped entry: ``rep_ids``
    and ``totals`` equal to the former B2 call over each occurrence's
    segment, bit for bit."""
    from ncf_tpu_torch.train.sparse import combine_duplicate_rows

    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.zipf(1.3, 3000) % 700)
    g = torch.from_numpy(rng.normal(size=(3000, 16)).astype(np.float32))
    rep_ids, totals = combine_duplicate_rows(ids, g, 700)
    n = ids.numel()
    ids_s, order = torch.sort(ids, stable=True)
    boundary = torch.ones_like(ids_s)
    boundary[1:] = ids_s[1:] != ids_s[:-1]
    seg_idx = torch.cumsum(boundary, 0) - 1
    seg_of = torch.empty_like(seg_idx)
    seg_of[order] = seg_idx
    want = tscatter.onehot_scatter_add(seg_of, g, n, mode="f32")
    want_ids = torch.arange(n) + 700
    want_ids.scatter_(0, seg_idx, ids_s)
    assert torch.equal(rep_ids, want_ids)
    assert np.array_equal(totals.numpy().view(np.int32),
                          want.numpy().view(np.int32))


def _record_launches(monkeypatch):
    """The card wrappers run on CPU tensors with the C call recorded and
    ``torch.sort`` counted."""
    calls, sorts = [], []
    real_sort = torch.sort
    monkeypatch.setattr(tscatter._kernels, "launch",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(tscatter._kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "sort",
                        lambda *a, **k: sorts.append(1) or real_sort(*a, **k))
    return calls, sorts


@pytest.mark.parametrize("rows,counting", [(7, True), (11264, True),
                                           (11265, False)])
def test_card_route_sorts_only_above_the_limit(monkeypatch, rows, counting):
    calls, sorts = _record_launches(monkeypatch)
    ids = torch.zeros((40, 5), dtype=torch.int64)
    tscatter._scatter_cuda(ids, torch.zeros((40, 5, 8)), rows, "split")
    (args,) = calls
    assert len(sorts) == (0 if counting else 1)
    lib, fn, codes = tscatter.C_ENTRY
    assert args[:3] == (lib, fn, codes) and len(args) == 3 + len(codes)
    ids_ptr, id_bytes, r, slots, keys_ptr = args[3:8]
    assert (r, slots) == (40, 5)
    assert (ids_ptr != 0, keys_ptr == 0) == (counting, counting)
    assert id_bytes == (8 if counting else 0)
    assert args[-3] == tscatter.scratch_ints(200, rows, counting)


def test_grouped_card_route_does_not_sort(monkeypatch):
    calls, sorts = _record_launches(monkeypatch)
    keys, order = torch.sort(torch.tensor([3, 1, 1, 0, 3]), stable=True)
    sorts.clear()
    tscatter._grouped_cuda(order, keys, torch.zeros((5, 4)), 5, "f32")
    assert not sorts and len(calls) == 1
    assert calls[0][5:8] == (5, 1, keys.data_ptr())


@pytest.mark.parametrize("table_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("ids_shape", ((300,), (40, 9)))
def test_b7_backward_is_b2_f32_cast_to_the_table(table_dtype, ids_shape):
    """B7's backward: the deterministic B2 in f32 mode over the ids
    flattened row-major (a negative id counting from the end), cast to the
    table's dtype."""
    rows, d = 60, 16
    rng = np.random.default_rng(11)
    tdt = getattr(torch, table_dtype)
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)
                             ).to(tdt).requires_grad_(True)
    ids = rng.integers(-rows, rows, ids_shape)
    ids.reshape(-1)[:40] = 3                # a repeated id
    ids = torch.from_numpy(ids)
    w = torch.from_numpy(rng.normal(size=ids_shape + (d,)).astype(np.float32))
    out = tgather.pallas_embedding_lookup(table, ids)
    assert torch.equal(out.detach(), table.detach()[ids])
    (out.float() * w).sum().backward()
    g = w.to(tdt)                            # the output gradient
    want = tscatter.onehot_scatter_add(
        torch.where(ids < 0, ids + rows, ids).reshape(-1),
        g.reshape(-1, d), rows, mode="f32").to(tdt)
    assert table.grad.dtype == tdt and torch.equal(table.grad, want)
    seq = _sequential(np.where(ids.numpy() < 0, ids.numpy() + rows,
                               ids.numpy()).reshape(-1),
                      g.float().numpy().reshape(-1, d), rows, "f32")
    assert torch.equal(table.grad, torch.from_numpy(seq).to(tdt))


def test_plain_b2_rounding_modes_differ_as_stated():
    ids, g = _ids_grads((3000,), 50, 8, seed=1)
    out = {m: tscatter.scatter_add_ref(torch.from_numpy(ids),
                                       torch.from_numpy(g), 50, m).numpy()
           for m in tscatter.MODES}
    mag = _magnitude(ids, g, 50)
    assert (np.abs(out["split"] - out["f32"]) <= (2 ** -18 + 2e-6) * mag).all()
    assert np.abs(out["bf16"] - out["f32"]).max() > 1e-4      # 8-bit mantissa
    with pytest.raises(ValueError):
        tscatter.onehot_scatter_add(torch.from_numpy(ids),
                                    torch.from_numpy(g), 50, mode="fp8")


SHAPES = [(6040, 128, 16384), (3706, 128, 81920), (9, 64, 3706),
          (30, 64, 3706), (24, 32, 16384), (100, 8, 50), (200000, 128, 4096),
          (3706, 12, 81920)]


@pytest.fixture
def scatter_impls():
    yield
    jemb.set_scatter_impl("auto")
    temb.set_scatter_impl("auto")


@pytest.mark.parametrize("impl,mode", [("auto", "split"), ("fast", "split"),
                                       ("auto", "bf16"), ("pallas", "f32"),
                                       ("pallas", "split"), ("xla", "split")])
def test_backward_routing_follows_the_reference(scatter_impls, impl, mode):
    # the port takes the reference's decision as it is on a TPU: the
    # configured mode where the reference would run its kernel, else f32
    jemb.set_scatter_impl(impl, mode)
    temb.set_scatter_impl(impl, mode)
    assert temb.get_scatter_impl() == jemb.get_scatter_impl() == impl
    for rows, d, n in SHAPES:
        if impl == "xla":
            kernel = False
        elif impl == "pallas":
            kernel = jscatter.scatter_fits(rows, d, n)
        else:
            kernel = jscatter.scatter_preferred(rows, d, n, jemb._SCATTER_MODE)
        want = jemb._SCATTER_MODE if kernel else "f32"
        assert temb.backward_mode(rows, d, n) == want, (rows, d, n)
        assert tscatter.scatter_fits(rows, d, n) == jscatter.scatter_fits(
            rows, d, n)


@pytest.mark.parametrize("ids_shape", ((2400,), (500, 5)))
@pytest.mark.parametrize("table_dtype", ("float32", "bfloat16"))
def test_embedding_lookup_gradient(scatter_impls, ids_shape, table_dtype):
    rows, d = 120, 16
    rng = np.random.default_rng(3)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    ids = rng.integers(0, rows, ids_shape).astype(np.int32)
    w = rng.normal(size=ids_shape + (d,)).astype(np.float32)
    jdt = jnp.bfloat16 if table_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, table_dtype)
    for impl in ("xla", "fast", "auto"):
        jemb.set_scatter_impl(impl)
        temb.set_scatter_impl(impl)
        t = torch.from_numpy(table).to(tdt).requires_grad_(True)
        out = temb.embedding_lookup(t, torch.from_numpy(ids))
        assert torch.equal(out.detach(), t.detach()[torch.from_numpy(ids).long()])
        (out.to(torch.float32) * torch.from_numpy(w)).sum().backward()
        # on the CPU the reference's routing takes XLA's scatter in the
        # table dtype; the port adds in f32 under the mode of its decision
        mode = temb.backward_mode(rows, d, ids.size)
        want = tscatter.scatter_add_ref(
            torch.from_numpy(ids), torch.from_numpy(w).to(tdt), rows,
            mode).to(tdt)
        assert t.grad.dtype == tdt
        assert torch.equal(t.grad, want)
        if table_dtype == "float32":
            jg = jax.grad(lambda tab: (jemb.embedding_lookup(
                tab, jnp.asarray(ids)).astype(jnp.float32) * w).sum())(
                jnp.asarray(table, jdt))
            # against XLA's exact f32 sum: split keeps |g - hi - lo| <=
            # 2^-18 |g| per element, bf16 |g - hi| <= 2^-9 |g|
            rel = {"f32": 2e-6, "split": 2 ** -18 + 2e-6, "bf16": 2 ** -8}
            tol = rel[mode] * _magnitude(ids, w, rows) + 1e-30
            assert (np.abs(t.grad.numpy() - np.asarray(jg)) <= tol).all()
