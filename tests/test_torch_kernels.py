"""The port's CUDA kernels against their plain PyTorch versions.

The card tests carry the ``cuda`` marker and skip without a card.  This
file imports neither JAX nor the JAX package, so on a machine with a GPU
and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances:

- streaming top-k (B5): values within 1e-5 * sum_d |q_d v_d| + 1e-6 (f32
  sums in another order); ids equal wherever the two rivals' exact scores
  differ by more than that;
- tree sampler (B1) and temporal sum (B3): equal, bit for bit (the same
  comparisons, the same order of f32 additions), B1 on sorted and iid
  uniforms;
- scatter-add (B2) and the row gather's backward through it: equal, bit
  for bit, to the plain version on the CPU and from run to run (both add
  each row's values in flattened order, in f32);
- int8 streaming top-k (B6) and row gather (B7): equal, bit for bit
  (integer arithmetic, so any order of the sums; a copy);
- exact top-k (B8) and the segmented top-k (B9, after its exact rescore):
  as the streaming top-k, with the queries in f32 (both keep them so);
  on small-integer data, whose sums are exact, equal; B9's keys where
  they differ from the plain version's: the plain winner's f64 score at
  most seg_width * ulp(|s| + 2 eps) + 2 eps above the kernel's, eps =
  1e-5 * sum_d |q_d v_d| + 1e-6 (``topk.segmax_key_violations``);
- B5 and B8 (tensor-core tiles): a user's answer equal bit for bit alone
  and inside a batch, and from one call to the next;
- fused tower (B4f, B4b): identical dropout zeros; outputs within 1e-4
  (relative, plus 1e-4) for at least 95% of the elements and within 5e-2
  of the largest magnitude for all: f32 sums run in another order, and
  where two of them straddle a bf16 rounding boundary between layers,
  that row's later values move by up to ~1e-2 (rows of 512 meet such a
  flip in a few percent of cases).  The backwards are held on the rows
  whose outputs agree to 1e-5 (at least 90%; dy is zero on the others):
  each parameter gradient within 1e-4 of its largest magnitude, dx
  within one bf16 ulp plus 1e-4 of its largest magnitude; two backward
  calls on the same inputs equal bit for bit.

The tests at the end, which check the ctypes bindings against the C
prototypes, run everywhere.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu_torch.ops import topk  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _exact(q, table, bias, ids, cast_q=True):
    qd = (q.to(table.dtype) if cast_q else q).double()
    prod = qd[:, None, :] * table[ids.long()].double()
    s = prod.sum(-1) + (0 if bias is None else bias.double()[ids.long()])
    return s, 1e-5 * prod.abs().sum(-1) + 1e-6


def _assert_close(kv, ki, rv, ri, q, table, bias, cast_q=True):
    valid = rv > topk.NEG_INF
    assert torch.equal(kv > topk.NEG_INF, valid)
    assert torch.equal(ki[~valid], ri[~valid])
    sk, tol_k = _exact(q, table, bias, ki, cast_q)
    sr, tol_r = _exact(q, table, bias, ri, cast_q)
    tol = torch.maximum(tol_k, tol_r)
    assert bool(((kv.double() - rv.double()).abs() <= tol)[valid].all())
    swap = (ki != ri) & valid
    assert bool(((sk - sr).abs() <= tol)[swap].all())


# batch sizes on both sides of every user tile (8, 16, 32, 64) of the
# tensor-core kernels; D 61 and 40 are padded to the product's depth and
# 61 f32 rows are not 16-byte aligned; 100,003 items divide no tile
_TILE_BS = (1, 7, 8, 9, 16, 17, 63, 64, 65, 300)
_DIMS = (64, 61, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("B", _TILE_BS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("seg", ((128, 2), (64, 1), (32, 2)))
@pytest.mark.parametrize("D", _DIMS)
def test_streaming_kernel_matches_plain_version(cuda, B, dtype, seg, D):
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    I = 100_003
    table = torch.randn((I, D), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((B, D), generator=gen, device=cuda)
    for b in (bias, None):
        for k in (1, 10, 64):
            args = dict(k=k, bias=b, seg_width=seg[0], seg_top=seg[1])
            n0 = topk.topk_scores_streaming.launches.value
            kv, ki = topk.topk_scores_streaming(q, table, **args)
            assert topk.topk_scores_streaming.launches.value == n0 + 1
            rv, ri = topk.topk_scores_streaming_ref(q, table, **args)
            torch.cuda.synchronize()
            _assert_close(kv, ki, rv, ri, q, table, b)


@pytest.mark.cuda
def test_streaming_kernel_prepared_table_and_empty_slots(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((5, 40), generator=gen, device=cuda)      # D % 32 != 0
    items = torch.randn((300, 40), generator=gen, device=cuda)
    bias = torch.randn((300,), generator=gen, device=cuda)
    prep = topk.prepare_items(items, bias, block_items=256, seg_width=64)
    kv, ki = topk.topk_scores_streaming(q, prep, k=20, seg_top=1)
    rv, ri = topk.topk_scores_streaming_ref(q, prep, k=20, seg_top=1)
    torch.cuda.synchronize()
    # 5 segments of 64 -> 5 candidates; slots 5.. are empty: NEG_INF with
    # the best id of the first 256-item block (the reference's carry)
    assert bool((kv[:, 5:] == torch.tensor(topk.NEG_INF)).all())
    first = torch.where(ki[:, :5] < 256, kv[:, :5],
                        torch.full_like(kv[:, :5], topk.NEG_INF)).argmax(1)
    assert torch.equal(ki[:, 5:], ki[torch.arange(5), first][:, None]
                       .expand(5, 15))
    _assert_close(kv, ki, rv, ri, q, items, bias)


@pytest.mark.cuda
def test_streaming_kernel_splits_large_batches(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((70, 64), generator=gen, device=cuda)
    items = torch.randn((20_000, 64), generator=gen, device=cuda)
    whole = topk.topk_scores_streaming(q, items, k=10)
    ncand = 20_000 // 128 * 2 + 2
    monkeypatch.setattr(topk, "_MAX_SCRATCH_BYTES", 16 * ncand * 8)
    n0 = topk.topk_scores_streaming.launches.value
    split = topk.topk_scores_streaming(q, items, k=10)
    assert topk.topk_scores_streaming.launches.value == n0 + 5   # 70 / 16
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])


@pytest.mark.cuda
def test_streaming_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 16), device=cuda)
    t = torch.zeros((500, 16), device=cuda)
    with pytest.raises(ValueError):
        topk.topk_scores_streaming(q, t, k=65)
    with pytest.raises(ValueError):
        topk.topk_scores_streaming(q, t, k=5, seg_width=256)
    with pytest.raises(TypeError):
        topk.topk_scores_streaming(q.half(), t.half(), k=5)
    wide = torch.zeros((500, 129), device=cuda)
    with pytest.raises(ValueError, match="dim <= 128"):
        topk.topk_scores_streaming(torch.zeros((2, 129), device=cuda), wide,
                                   k=5)


@pytest.mark.cuda
@pytest.mark.parametrize("num_items", (100, 3706, 100_003))
@pytest.mark.parametrize("rounds", (1, 2))
@pytest.mark.parametrize("sort", (False, True))
@pytest.mark.parametrize("cdf_on", ("card", "cpu"))
def test_tree_sampler_kernel_equals_plain_version(cuda, num_items, rounds,
                                                  sort, cdf_on):
    """Sorted and iid uniforms; the CDF summed on the CPU in order, as
    ``make_sampling_cdf`` sums it (every slot equal), or by the card's
    parallel scan, which may fall by an ulp here and there: then equal on
    every slot whose uniforms see it ordered (``sampler.ordered_for``),
    the kernel's contract."""
    from ncf_tpu_torch.ops import sampler

    gen = torch.Generator(device=cuda).manual_seed(num_items + rounds)
    w = torch.rand(num_items, generator=gen, device=cuda) + 1e-3
    cdf = (torch.cumsum(w, 0) if cdf_on == "card"
           else torch.cumsum(w.cpu(), 0).to(cuda))
    cdf = cdf / cdf[-1]
    for B, NEG in ((16384, 4), (65536, 1), (37, 3)):
        u = torch.rand((rounds, B * NEG), generator=gen, device=cuda)
        u[0, :3] = torch.stack([cdf[0], cdf[-1], cdf[num_items // 2]])
        if sort:
            u = torch.sort(u, dim=1).values
        pos = torch.randint(-1, num_items, (B,), generator=gen, device=cuda,
                            dtype=torch.int32)
        n0 = sampler.tree_sample_negatives.launches.value
        got = sampler.tree_sample_negatives(u, pos, cdf, num_items)
        assert sampler.tree_sample_negatives.launches.value == n0 + 1
        pos_bn = pos[:, None].expand(B, NEG).reshape(-1)
        want = sampler.tree_sample_ref(u, pos_bn, cdf, num_items)
        keep = sampler.ordered_for(u, cdf).all(0)
        torch.cuda.synchronize()
        assert cdf_on == "card" or bool(keep.all())
        assert torch.equal(got.reshape(-1)[keep], want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("num_items", (1682, 3706, 20_000))
@pytest.mark.parametrize("N", (65536, 9999, 1001, 3))
def test_tree_sampler_kernel_keeps_the_edge_cases(cuda, num_items, N):
    """Bit for bit with the plain version, one round, sorted and unsorted:
    runs of equal CDF entries (zero-weight items), uniforms on entries,
    at and above cdf[-1], NaN and duplicates; N not a multiple of four
    slots and below one block of 1,024; a catalog above the 12,288 items
    a block stages."""
    from ncf_tpu_torch.ops import sampler

    gen = torch.Generator(device=cuda).manual_seed(num_items + N)
    w = torch.rand(num_items, generator=gen, device=cuda).cpu()
    w[torch.rand(num_items, generator=gen, device=cuda).cpu() < 0.3] = 0.0
    w[-20:] = 0.0
    cdf = torch.cumsum(w, 0)                    # a sequential, monotone sum
    cdf = (cdf / cdf[-1]).to(cuda)
    u = torch.rand(N, generator=gen, device=cuda)
    on = torch.randint(0, num_items, (N // 10,), generator=gen, device=cuda)
    u[:N // 10] = cdf[on]
    u[N // 10:N // 5] = cdf[-1] + u[N // 10:N // 5]
    u[-(N // 7 + 1):] = u[0]
    u[N // 2] = float("nan")
    no_pos = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    for order in ("sorted", "unsorted"):
        x = (torch.sort(u).values if order == "sorted" else u)[None]
        want = sampler.tree_sample_ref(x, no_pos, cdf, num_items)
        got = sampler.tree_sample_negatives(x, no_pos, cdf, num_items)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(-1), want), order


def _scatter_ids(gen, dev, shape, rows, skew):
    """ids of ``shape`` for a table of ``rows``: uniform with some out of
    range, every id one row (``"repeated"``), or a popularity skew."""
    if skew == "repeated":
        return torch.full(shape, rows // 2, dtype=torch.int32, device=dev)
    if skew == "zipf":
        u = torch.rand(shape, generator=gen, device=dev)
        return (u.pow(-1.0 / 0.3) - 1.0).clamp(max=rows + 1).to(torch.int32)
    return torch.randint(-2, rows + 2, shape, generator=gen, device=dev,
                         dtype=torch.int32)                 # some out of range


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("split", "bf16", "f32"))
@pytest.mark.parametrize("shape,rows,d,dtype,skew", [
    ((16384,), 6040, 128, "bfloat16", "uniform"),
    ((16384, 5), 3706, 128, "bfloat16", "uniform"),
    ((3706,), 9, 64, "float32", "uniform"),
    ((16384,), 24, 32, "float32", "uniform"),
    ((1000, 3), 77, 40, "float32", "uniform"),
    ((16384, 5), 3706, 128, "bfloat16", "zipf"),
    ((16384,), 7, 32, "float32", "zipf"),
    ((16384, 5), 3706, 128, "float32", "repeated"),
    ((4096,), 3, 200, "float32", "uniform"),
    ((0,), 5, 8, "bfloat16", "uniform")])
def test_scatter_kernel_matches_plain_version(cuda, mode, shape, rows, d,
                                              dtype, skew):
    from ncf_tpu_torch.ops import scatter

    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    ids = _scatter_ids(gen, cuda, shape, rows, skew)
    g = torch.randn(shape + (d,), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    n0 = scatter.onehot_scatter_add.launches.value
    got = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
    assert scatter.onehot_scatter_add.launches.value == n0 + 1
    again = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
    want = scatter.scatter_add_ref(ids.cpu(), g.cpu(), rows, mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    assert torch.equal(got, again)                  # from run to run
    assert torch.equal(got.cpu(), want)             # bit for bit


def _sequential_sum(ids, g, rows, mode):
    """Each row's rounded values summed in flattened order from 0.0 in f32
    (``np.add.at`` adds in index order), on the CPU: B2's function."""
    import numpy as np

    from ncf_tpu_torch.ops import scatter

    flat, fg = scatter._flat(ids.cpu().long(), g.cpu())
    keep = (flat >= 0) & (flat < rows)
    out = np.zeros((rows, g.shape[-1]), np.float32)
    np.add.at(out, flat[keep].numpy(),
              scatter.round_mode(fg[keep], mode).numpy())
    return torch.from_numpy(out)


def _route_edge(name, gen, dev):
    """(ids, rows, D, grads dtype) of a route edge of B2."""
    from ncf_tpu_torch.ops import scatter

    def uniform(shape, rows, dtype=torch.int32):
        return torch.randint(-2, rows + 2, shape, generator=gen, device=dev,
                             dtype=dtype)

    if name == "at_limit":
        return uniform((16384, 5), scatter.ROW_LIMIT), scatter.ROW_LIMIT, \
            128, torch.bfloat16
    if name == "above_limit":
        r = scatter.ROW_LIMIT + 1
        return uniform((16384, 5), r), r, 128, torch.bfloat16
    if name == "one_id":                       # 81,920 positions, one row
        return torch.full((16384, 5), 1234, dtype=torch.int32,
                          device=dev), 3706, 128, torch.bfloat16
    if name == "out_of_range":
        ids = torch.randint(3706, 9000, (16384, 5), generator=gen,
                            device=dev, dtype=torch.int32)
        ids[:, ::2] *= -1
        return ids, 3706, 128, torch.float32
    if name == "ragged":                       # n not a multiple of CHUNK
        return uniform((3 * scatter.CHUNK + 77,), 24), 24, 32, torch.float32
    if name == "int64":                        # past 2^31: out of range
        ids = uniform((16384,), 6040, torch.int64)
        ids[::7] += 2 ** 32
        return ids, 6040, 128, torch.bfloat16
    if name == "small_limit":                  # the small route's edge
        return uniform((scatter.SMALL_N,), scatter.SMALL_ROWS), \
            scatter.SMALL_ROWS, 64, torch.bfloat16
    if name == "small_above":                  # one past it: counting
        return uniform((scatter.SMALL_N + 1,), 7), 7, 32, torch.float32
    if name == "long_runs":                    # a few hundred a row, D 200
        return uniform((60000,), 150), 150, 200, torch.float32
    # grown chunks: past CHUNK * MAX_CHUNKS positions
    n = scatter.CHUNK * scatter.MAX_CHUNKS + 4097
    return uniform((n,), 7), 7, 32, torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("split", "f32"))
@pytest.mark.parametrize("name", ("at_limit", "above_limit", "one_id",
                                  "out_of_range", "ragged", "int64",
                                  "small_limit", "small_above", "long_runs",
                                  "big_n"))
def test_scatter_kernel_route_edges(cuda, mode, name):
    """B2 at its routes' edges (the row count at the counting route's
    limit and one above, one id 81,920 times, every id out of range, n
    not a multiple of the chunk, int64 ids, the small tables' route at
    its row and position limits and one position past them, runs of
    hundreds at D 200, grown chunks): bit for bit with the sequential f32
    sum and from call to call."""
    from ncf_tpu_torch.ops import scatter

    gen = torch.Generator(device=cuda).manual_seed(len(name))
    ids, rows, d, dtype = _route_edge(name, gen, cuda)
    g = torch.randn(tuple(ids.shape) + (d,), generator=gen,
                    device=cuda).to(dtype)
    n0 = scatter.onehot_scatter_add.launches.value
    got = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
    again = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
    torch.cuda.synchronize()
    assert scatter.onehot_scatter_add.launches.value == n0 + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), _sequential_sum(ids, g, rows, mode))
    if name in ("at_limit", "ragged", "one_id"):
        assert torch.equal(got.cpu(), scatter.scatter_add_ref(
            ids.cpu(), g.cpu(), rows, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,d", [(16384, 16384, 128), (81920, 81920, 64),
                                      (4096, 100, 32), (1, 5, 8)])
def test_scatter_kernel_grouped_entry(cuda, n, rows, d):
    """The sparse combine's entry: given ``torch.sort``'s grouping of ids
    with duplicates, equal bit for bit to B2 on the ids and to the
    combine's former call over each occurrence's segment."""
    from ncf_tpu_torch.ops import scatter
    from ncf_tpu_torch.train.sparse import combine_duplicate_rows

    gen = torch.Generator(device=cuda).manual_seed(n)
    u = torch.rand(n, generator=gen, device=cuda)
    ids = (u.pow(-1.0 / 0.4) - 1.0).clamp(max=rows - 1).long()   # skewed
    g = torch.randn((n, d), generator=gen, device=cuda)
    keys, order = torch.sort(ids, stable=True)
    n0 = scatter.onehot_scatter_add.launches.value
    got = scatter.scatter_add_grouped(order, keys, g, rows, mode="f32")
    assert scatter.onehot_scatter_add.launches.value == n0 + 1
    want = scatter.onehot_scatter_add(ids, g, rows, mode="f32")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), _sequential_sum(ids, g, rows, "f32"))
    rep, totals = combine_duplicate_rows(ids, g, rows)
    boundary = torch.ones_like(keys)
    boundary[1:] = keys[1:] != keys[:-1]
    seg_idx = torch.cumsum(boundary, 0) - 1
    seg_of = torch.empty_like(seg_idx)
    seg_of[order] = seg_idx
    want_t = scatter.onehot_scatter_add(seg_of, g, n, mode="f32")
    want_rep = torch.arange(n, device=cuda) + rows
    want_rep.scatter_(0, seg_idx, keys)
    torch.cuda.synchronize()
    assert torch.equal(rep, want_rep) and torch.equal(totals, want_t)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (16384, 4096, 5))
def test_temporal_sum_kernel_equals_plain_version(cuda, B):
    from ncf_tpu_torch.models.temporal import sinusoidal_table
    from ncf_tpu_torch.ops import scatter, temporal_sum

    gen = torch.Generator(device=cuda).manual_seed(B)
    rows = (24, 7, 12, 365)
    tables = [torch.randn((r, 32), generator=gen, device=cuda)
              for r in rows[:3]] + [sinusoidal_table(32, device=cuda)]
    ids = torch.stack([torch.randint(-1, r + 1, (B,), generator=gen,
                                     device=cuda) for r in rows])
    n0 = temporal_sum.fused_lookup_sum.launches.value
    got = temporal_sum.fused_lookup_sum(ids, tables)
    assert temporal_sum.fused_lookup_sum.launches.value == n0 + 1
    want = temporal_sum.lookup_sum_ref(ids, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the gradient: B2 in split mode per learned table, none for pe
    ts = [t.clone().requires_grad_(k < 3) for k, t in enumerate(tables)]
    n1 = scatter.onehot_scatter_add.launches.value
    temporal_sum.fused_lookup_sum(ids, ts).sum().backward()
    assert scatter.onehot_scatter_add.launches.value == n1 + 3
    assert ts[3].grad is None
    for k in range(3):
        want = scatter.scatter_add_ref(ids[k].cpu(), torch.ones((B, 32)),
                                       rows[k], "split")
        torch.cuda.synchronize()
        assert torch.equal(ts[k].grad.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 3, 5, 4097, 16384))
@pytest.mark.parametrize("K", (1, 2, 3, 4))
@pytest.mark.parametrize("dt,offset", ((32, 0), (33, 0), (32, 1), (1028, 0)))
def test_temporal_sum_kernel_edge_cases(cuda, B, K, dt, offset):
    """Bit for bit with the plain version for every table count, ids of
    -1, ``rows`` and far out of range, the 16-byte path (dt 32 and 1028,
    whose rows take more than one block's threads) and the one-float path
    (dt 33, or tables one float off 16-byte alignment)."""
    from ncf_tpu_torch.ops import temporal_sum

    gen = torch.Generator(device=cuda).manual_seed(B * 7 + K)
    rows = (24, 7, 12, 365)[:K]
    tables = []
    for r in rows:
        flat = torch.randn(r * dt + offset, generator=gen, device=cuda)
        tables.append(flat[offset:].view(r, dt))
    ids = torch.stack([torch.randint(0, r, (B,), generator=gen, device=cuda)
                       for r in rows]).to(torch.int32)
    ids[:, 0] = -1
    if B > 1:
        ids[:, 1] = torch.tensor(rows, device=cuda, dtype=torch.int32)
    if B > 2:
        ids[:, 2] = 2 ** 31 - 1
        ids[0, B // 2:] = -(2 ** 31)
    want = temporal_sum.lookup_sum_ref(ids, tables)
    n0 = temporal_sum.fused_lookup_sum.launches.value
    got = temporal_sum._lookup_sum_cuda(ids, tables)
    torch.cuda.synchronize()
    assert temporal_sum.fused_lookup_sum.launches.value == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from ncf_tpu_torch.ops import sampler, scatter, temporal_sum

    with pytest.raises(TypeError):
        sampler.tree_sample_negatives(
            torch.zeros((1, 8), device=cuda, dtype=torch.float64),
            torch.zeros(8, device=cuda, dtype=torch.int32),
            torch.ones(4, device=cuda), 4)
    with pytest.raises(TypeError):
        scatter.onehot_scatter_add(
            torch.zeros(4, device=cuda, dtype=torch.int32),
            torch.zeros((4, 8), device=cuda, dtype=torch.float16), 3)
    with pytest.raises(TypeError):
        temporal_sum.fused_lookup_sum(
            torch.zeros((1, 4), device=cuda, dtype=torch.int32),
            [torch.zeros((3, 8), device=cuda, dtype=torch.float64)])


def _tower_case(shape, hidden, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers, cur = [], shape[-1]
    for h in hidden:
        bound = cur ** -0.5
        layers.append({
            "dense": {"w": (torch.rand((cur, h), generator=gen, device=dev)
                            * 2 - 1) * bound,
                      "b": (torch.rand(h, generator=gen, device=dev) * 2 - 1)
                      * bound},
            "norm": {"scale": 1 + 0.1 * torch.randn(h, generator=gen,
                                                    device=dev),
                     "bias": 0.1 * torch.randn(h, generator=gen, device=dev)}})
        cur = h
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return layers, x


def _tower_fwd(fn, layers, x, rate, seed):
    """``fn`` on copies of the leaves: (out, x copy, leaves in packing
    order), with the generator seeded ``seed``."""
    tracked = [{k: {n: t.detach().clone().requires_grad_(True)
                    for n, t in layer[k].items()} for k in ("dense", "norm")}
               for layer in layers]
    leaves = [layer[a][b] for layer in tracked
              for a, b in (("dense", "w"), ("dense", "b"), ("norm", "scale"),
                           ("norm", "bias"))]
    xt = x.detach().clone().requires_grad_(True)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return fn(tracked, xt, rate, gen, rate == 0.0), xt, leaves


@pytest.mark.cuda
@pytest.mark.parametrize("rate", (0.0, 0.2))
@pytest.mark.parametrize("shape,hidden", [
    ((16384, 96), [256, 128, 64]), ((4096, 160), [256, 128, 64]),
    ((1, 96), [256, 128, 64]), ((1025, 96), [256, 128, 64]),
    ((40, 5, 96), [256, 128, 64]), ((333, 96), [64]),
    ((257, 512), [512, 512, 64]), ((300, 37), [45, 3]),
    ((129, 96), [256, 128, 64]), ((16383, 96), [256, 128, 64]),
    ((16383, 160), [256, 128, 64])])
def test_fused_tower_kernels_match_plain_version(cuda, shape, hidden, rate):
    from ncf_tpu_torch.ops import tower

    layers, x = _tower_case(shape, hidden, cuda, len(hidden) + shape[0])
    f0 = tower.fused_tower.fwd_launches.value
    b0 = tower.fused_tower.bwd_launches.value
    ko, kx, kl = _tower_fwd(tower.fused_tower, layers, x, rate, 3)
    ro, rx, rl = _tower_fwd(tower.fused_tower_ref, layers, x, rate, 3)
    assert tower.fused_tower.fwd_launches.value == f0 + 1
    assert ko.shape == ro.shape == shape[:-1] + (hidden[-1],)
    assert torch.equal(ko == 0, ro == 0)              # the same masks
    if rate:
        assert abs(float((ro == 0).float().mean()) - rate) < 0.05
    err = (ko - ro).abs().detach()
    scale = 1 + ro.abs().detach()
    assert float((err <= 1e-4 * scale).float().mean()) >= 0.95
    assert float(err.max()) <= 5e-2 * float(ro.detach().abs().max())
    # the backwards on the rows whose forwards agree to f32 rounding (a
    # bf16 flip between layers moves the rest of its row): tight there
    same = (err <= 1e-5 * scale).reshape(-1, err.shape[-1]).all(-1)
    assert float(same.float().mean()) >= 0.9
    dy = torch.randn(ko.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(5))
    dy = dy * same.reshape(ko.shape[:-1] + (1,))
    ko.backward(dy)
    ro.backward(dy)
    assert tower.fused_tower.bwd_launches.value == b0 + 1
    torch.cuda.synchronize()
    got, want = kx.grad.float(), rx.grad.float()
    assert bool((got - want).abs().le(2.0 ** -7 * want.abs() + 1e-4
                                      * float(want.abs().max())).all())
    for k, r in zip(kl, rl):
        assert float((k.grad - r.grad).abs().max()) <= \
            1e-4 * float(r.grad.abs().max()) + 1e-6


@pytest.mark.cuda
def test_fused_tower_backward_gives_equal_bits_call_to_call(cuda):
    """B4b sums each weight gradient over tiles and blocks in a fixed
    order: two calls on the same inputs give the same bits in dx and
    every gradient."""
    from ncf_tpu_torch.ops import tower

    layers, x = _tower_case((16384, 96), [256, 128, 64], cuda, 7)
    flat = [layer[a][b] for layer in layers
            for a, b in (("dense", "w"), ("dense", "b"), ("norm", "scale"),
                         ("norm", "bias"))]
    seed = torch.tensor([987], dtype=torch.int32, device=cuda)
    dy = torch.randn((16384, 64), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(8))
    runs = [tower._bwd_cuda(x, dy, seed, flat, 0.2) for _ in range(2)]
    (dx1, g1), (dx2, g2) = runs
    assert torch.equal(dx1, dx2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_tower_kernels_refuse_what_they_do_not_take(cuda):
    from ncf_tpu_torch.ops import tower

    for hidden in ([16] * 17, [600]):
        layers, x = _tower_case((8, 16), hidden, cuda, 0)
        with pytest.raises(ValueError):
            tower.fused_tower(layers, x)


def test_streaming_raises_off_cpu_and_cuda():
    q = torch.zeros((2, 16), device="meta")
    t = torch.zeros((500, 16), device="meta")
    with pytest.raises(RuntimeError, match="no streaming kernel"):
        topk.topk_scores_streaming(q, t, k=5)


# ------------------------------------- B6, B7, B8, B9 (slice 4's kernels)

@pytest.mark.cuda
@pytest.mark.parametrize("B", _TILE_BS)
@pytest.mark.parametrize("D", (16, 40, 61, 64, 100))
def test_int8_kernel_equals_plain_version(cuda, B, D):
    """Every user tile (B on both sides of 8, 16, 32, 64) and rows of K =
    D + 3 bytes, none a multiple of 16 (spans of 128 rows still are);
    100,003 items pad to a block multiple."""
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    I = 100_003
    items = torch.randn((I, D), generator=gen, device=cuda)
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((B, D), generator=gen, device=cuda)
    for seg in (128, 64, 32):
        prep = topk.prepare_items_int8(items, bias, q, seg_width=seg)
        for seg_top in (1, 2):
            for k in (1, 10, 64):
                n0 = topk.topk_scores_streaming_int8.launches.value
                kv, ki = topk.topk_scores_streaming_int8(q, prep, k,
                                                         seg_top=seg_top)
                assert topk.topk_scores_streaming_int8.launches.value == n0 + 1
                rv, ri = topk.topk_scores_streaming_int8_ref(
                    q, prep, k, seg_top=seg_top)
                assert torch.equal(ki, ri) and torch.equal(kv, rv)


@pytest.mark.cuda
@pytest.mark.parametrize("D", (64, 61))
def test_int8_kernel_serves_a_user_alone_as_in_a_batch(cuda, D):
    gen = torch.Generator(device=cuda).manual_seed(D)
    items = torch.randn((200_000, D), generator=gen, device=cuda)
    q = torch.randn((64, D), generator=gen, device=cuda)
    prep = topk.prepare_items_int8(items, None, q, seg_width=64)
    for seg_top in (1, 2):
        whole = topk.topk_scores_streaming_int8(q, prep, 10, seg_top=seg_top)
        part = topk.topk_scores_streaming_int8(q[:17], prep, 10,
                                               seg_top=seg_top)
        for u in (0, 5, 16, 63):
            alone = topk.topk_scores_streaming_int8(q[u:u + 1], prep, 10,
                                                    seg_top=seg_top)
            for got in ((whole,) if u > 16 else (whole, part)):
                assert torch.equal(alone[0][0], got[0][u])
                assert torch.equal(alone[1][0], got[1][u])
        again = topk.topk_scores_streaming_int8(q, prep, 10, seg_top=seg_top)
        assert torch.equal(whole[0], again[0]) and torch.equal(whole[1],
                                                               again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", (200, 600, 1000))
def test_int8_kernel_takes_wide_rows(cuda, D):
    """Rows wider than 128 bytes read the queries from shared memory every
    tile; four stages of 128 rows fit up to K ~ 440 bytes, D = 600 takes
    two, D = 1000 (K = 1003) one."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    items = torch.randn((5_000, D), generator=gen, device=cuda)
    q = torch.randn((9, D), generator=gen, device=cuda)
    prep = topk.prepare_items_int8(items, None, q, seg_width=128)
    for seg_top in (1, 2):
        got = topk.topk_scores_streaming_int8(q, prep, 20, seg_top=seg_top)
        want = topk.topk_scores_streaming_int8_ref(q, prep, 20,
                                                   seg_top=seg_top)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_int8_kernel_reads_a_table_off_16_byte_alignment(cuda):
    """A prepared table whose base is not 16-byte aligned (a view one byte
    into its storage) takes the kernel's byte copies."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    items = torch.randn((30_000, 64), generator=gen, device=cuda)
    q = torch.randn((17, 64), generator=gen, device=cuda)
    prep = topk.prepare_items_int8(items, None, q, seg_width=64)
    n, k8 = prep.table.shape
    moved = torch.empty(n * k8 + 1, dtype=torch.int8, device=cuda)[1:]
    moved = moved.view(n, k8)
    moved.copy_(prep.table)
    assert moved.data_ptr() % 16 != 0
    want = topk.topk_scores_streaming_int8(q, prep, 10)
    prep.table = moved
    got = topk.topk_scores_streaming_int8(q, prep, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_int8_kernel_ties_padded_rows_and_fill(cuda):
    """Small-integer tables (ties everywhere), real items below the padded
    rows' floor, and fewer candidates than k."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    items = torch.randint(-1, 2, (20_000, 8), generator=gen,
                          device=cuda).float()
    q = torch.randint(-1, 2, (9, 8), generator=gen, device=cuda).float()
    low = torch.full((300, 8), -1.0, device=cuda)
    low[:, 0] += torch.linspace(0, 0.5, 300, device=cuda)
    for it, b, qq, block, seg, k in (
            (items, items[:, 0] * 0 + 1, q, 512, 32, 64),
            (low, torch.full((300,), -1e9, device=cuda),
             torch.ones((3, 8), device=cuda), 256, 64, 10),
            (items[:200], None, q, 64, 64, 10)):
        prep = topk.prepare_items_int8(it, b, qq, block_items=block,
                                       seg_width=seg)
        for seg_top in (1, 2):
            got = topk.topk_scores_streaming_int8(qq, prep, k,
                                                  seg_top=seg_top)
            want = topk.topk_scores_streaming_int8_ref(qq, prep, k,
                                                       seg_top=seg_top)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B", _TILE_BS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("D", _DIMS)
def test_exact_kernel_matches_plain_version(cuda, B, dtype, D):
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    I = 100_003
    table = torch.randn((I, D), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((B, D), generator=gen, device=cuda)
    for b in (bias, None):
        for k in (1, 10, 64, 256):
            kv, ki = topk.topk_scores_pallas(q, table, k, b)
            rv, ri = topk.topk_scores_pallas_ref(q, table, k, b)
            _assert_close(kv, ki, rv, ri, q, table, b, cast_q=False)


@pytest.mark.cuda
def test_exact_kernel_ties_and_empty_slots(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    t = torch.randint(-1, 2, (9_000, 16), generator=gen, device=cuda).float()
    q = torch.randint(-1, 2, (17, 16), generator=gen, device=cuda).float()
    b = torch.randint(0, 2, (9_000,), generator=gen, device=cuda).float()
    b[:8_990] = topk.NEG_INF                 # ten real items, k above
    for bias, k in ((None, 200), (b, 30)):
        for block in (2048, 512):
            got = topk.topk_scores_pallas(q, t, k, bias, block_items=block)
            want = topk.topk_scores_pallas_ref(q, t, k, bias,
                                               block_items=block)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])


@pytest.mark.cuda
def test_exact_kernel_splits_large_batches(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((70, 64), generator=gen, device=cuda)
    items = torch.randn((20_000, 64), generator=gen, device=cuda)
    whole = topk.topk_scores_pallas(q, items, 10)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ncand = min(-(-20_000 // 128), sms) * 10
    monkeypatch.setattr(topk, "_MAX_SCRATCH_BYTES", 16 * ncand * 8)
    n0 = topk.topk_scores_pallas.launches.value
    split = topk.topk_scores_pallas(q, items, 10)
    assert topk.topk_scores_pallas.launches.value == n0 + 5   # 70 / 16
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("streaming", "exact"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_tensor_core_kernels_serve_a_user_alone_as_in_a_batch(cuda, kernel,
                                                              dtype):
    """A user's answer is bit for bit the same served alone (user tile 8)
    as inside a batch of 64 (tile 64) or 17 (tile 32), and two calls give
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    I = 300_001
    table = torch.randn((I, 64), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((64, 64), generator=gen, device=cuda)
    if kernel == "streaming":
        prep = topk.prepare_items(table, bias, seg_width=128)

        def call(x):
            return topk.topk_scores_streaming(x, prep, k=10)
    else:
        def call(x):
            return topk.topk_scores_pallas(x, table, 10, bias)
    batch = call(q)
    again = call(q)
    assert torch.equal(batch[0], again[0]) and torch.equal(batch[1], again[1])
    part = call(q[40:57])
    for u in (0, 5, 40, 47, 56, 63):
        alone = call(q[u:u + 1])
        assert torch.equal(alone[0][0], batch[0][u])
        assert torch.equal(alone[1][0], batch[1][u])
        if 40 <= u < 57:
            assert torch.equal(part[0][u - 40], batch[0][u])
            assert torch.equal(part[1][u - 40], batch[1][u])


@pytest.mark.cuda
@pytest.mark.parametrize("D", (100, 128))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_tensor_core_kernels_take_rows_up_to_128(cuda, D, dtype):
    """The widest rows B5 and B8 take: their launchers halve the user tile
    until the ring (and B8's candidate buffers, k up to 256) fit."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    I = 50_001
    table = torch.randn((I, D), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((I,), generator=gen, device=cuda)
    for B in (9, 64):
        q = torch.randn((B, D), generator=gen, device=cuda)
        kv, ki = topk.topk_scores_streaming(q, table, k=10, bias=bias)
        rv, ri = topk.topk_scores_streaming_ref(q, table, k=10, bias=bias)
        _assert_close(kv, ki, rv, ri, q, table, bias)
        for k in (10, 256):
            kv, ki = topk.topk_scores_pallas(q, table, k, bias)
            rv, ri = topk.topk_scores_pallas_ref(q, table, k, bias)
            _assert_close(kv, ki, rv, ri, q, table, bias, cast_q=False)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 9, 64, 65))
@pytest.mark.parametrize("seg", (128, 64, 32))
def test_segmented_kernel_matches_plain_version(cuda, B, seg):
    gen = torch.Generator(device=cuda).manual_seed(B + seg)
    I = 100_003
    table = torch.randn((I, 64), generator=gen, device=cuda)
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((B, 64), generator=gen, device=cuda)
    for b in (bias, None):
        kv, ki = topk.topk_scores_segmented(q, table, 10, b, seg_width=seg)
        rv, ri = topk.topk_scores_segmented_ref(q, table, 10, b,
                                                seg_width=seg)
        _assert_close(kv, ki, rv, ri, q, table, b, cast_q=False)
        for t in (table, table.to(torch.bfloat16)):
            keys = topk._segmax_cuda(q, t, b, 2048, seg)
            want = topk.segmax_keys_ref(q, t, b, 2048, seg)
            bad = topk.segmax_key_violations(q, t, b, keys, want, seg)[1]
            assert bad == 0
    # exact sums: the keys themselves are equal
    ti = torch.randint(-2, 3, (5_000, 16), generator=gen, device=cuda).float()
    qi = torch.randint(-2, 3, (B, 16), generator=gen, device=cuda).float()
    keys = topk._segmax_cuda(qi, ti, None, 2048, seg)
    assert torch.equal(keys, topk.segmax_keys_ref(qi, ti, None, 2048, seg))


@pytest.mark.cuda
@pytest.mark.parametrize("D", (100, 128, 129))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_segmented_kernel_takes_rows_up_to_128(cuda, D, dtype):
    """B9's keys on the tensor-core tile at the widest rows it stages;
    wider rows raise on CUDA tensors (the plain version takes any)."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    table = torch.randn((20_001, D), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((20_001,), generator=gen, device=cuda)
    for B in (5, 64):
        q = torch.randn((B, D), generator=gen, device=cuda)
        want = topk.segmax_keys_ref(q, table, bias, 2048, 128)
        if D > 128:
            with pytest.raises(ValueError, match="dim <= 128"):
                topk._segmax_cuda(q, table, bias, 2048, 128)
            continue
        keys = topk._segmax_cuda(q, table, bias, 2048, 128)
        bad = topk.segmax_key_violations(q, table, bias, keys, want, 128)[1]
        assert bad == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("bfloat16", 34), ("float32", 3)])
def test_gather_kernel_equals_plain_version(cuda, dtype, d):
    from ncf_tpu_torch.ops import gather

    gen = torch.Generator(device=cuda).manual_seed(d)
    table = torch.randn((3706, d), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    ids = torch.randint(-3706, 3706, (64, 3706), generator=gen, device=cuda)
    for i in (ids, ids.to(torch.int32)):
        got = gather.gather_rows(table, i)
        assert torch.equal(got, gather.gather_rows_ref(table, i))
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        gather.gather_rows(table[:, :1].to(torch.bfloat16), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_gather_backward_is_deterministic(cuda, dtype):
    """B7's backward goes through B2 (f32 mode): two calls give the same
    bits, equal to the CPU's."""
    from ncf_tpu_torch.ops import gather, scatter

    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn((3706, 64), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    ids = torch.randint(-3706, 3706, (64, 3706), generator=gen, device=cuda)
    ids[:, :500] = 11                                # a long run
    w = torch.randn((64, 3706, 64), generator=gen, device=cuda)
    grads = []
    for t in (table, table, table.cpu()):
        t = t.clone().requires_grad_(True)
        n0 = scatter.onehot_scatter_add.launches.value
        (gather.pallas_embedding_lookup(t, ids.to(t.device)).float()
         * w.to(t.device)).sum().backward()
        assert scatter.onehot_scatter_add.launches.value == n0 + (
            t.device.type == "cuda")
        grads.append(t.grad.cpu())
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])



@pytest.mark.cuda
def test_slice4_kernels_refuse_what_they_do_not_take(cuda):
    items = torch.randn((1000, 16), device=cuda)
    q = torch.randn((4, 16), device=cuda)
    prep = topk.prepare_items_int8(items, None, q, block_items=256,
                                   seg_width=256)
    with pytest.raises(ValueError, match="seg_width"):
        topk.topk_scores_streaming_int8(q, prep, 5)
    prep = topk.prepare_items_int8(items, None, q, block_items=256)
    with pytest.raises(ValueError, match="k <= 64"):
        topk._streaming_int8_cuda(topk._quantize_queries(q, prep), prep,
                                  65, 1)
    with pytest.raises(ValueError, match="256"):
        topk.topk_scores_pallas(q, items, 257)
    with pytest.raises(TypeError):
        topk.topk_scores_pallas(q, items.double(), 5)
    with pytest.raises(ValueError, match="dim <= 128"):
        topk.topk_scores_pallas(torch.zeros((2, 129), device=cuda),
                                torch.zeros((500, 129), device=cuda), 5)
    with pytest.raises(ValueError, match="seg_width"):
        topk.topk_scores_segmented(q, items, 5, seg_width=8)


def test_slice4_wrappers_raise_off_cpu_and_cuda():
    from ncf_tpu_torch.ops import gather

    q = torch.zeros((2, 16), device="meta")
    t = torch.zeros((500, 16), device="meta")
    prep = topk.prepare_items_int8(t, None, q, block_items=128)
    with pytest.raises(RuntimeError, match="no int8 streaming kernel"):
        topk.topk_scores_streaming_int8(q, prep, 5)
    with pytest.raises(RuntimeError, match="no exact top-k kernel"):
        topk.topk_scores_pallas(q, t, 5)
    with pytest.raises(RuntimeError, match="no segmented kernel"):
        topk.topk_scores_segmented(q, t, 5)
    with pytest.raises(RuntimeError, match="no gather kernel"):
        gather.gather_rows(t, torch.zeros(3, dtype=torch.long,
                                          device="meta"))


# ------------------------------------------------- bindings, checked here

def _prototypes():
    """{C function: argument codes} parsed from the ``extern "C"`` entry
    points of ``csrc/*.cu`` (pointer ``p``, int ``i``, long long ``l``)."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(_kernels.__file__), "csrc")
    out = {}
    for name in _kernels.SOURCES:
        with open(os.path.join(csrc, name + ".cu")) as f:
            src = f.read()
        for fn, args in re.findall(r"^int (ncf_\w+)\(([^)]*)\)", src, re.M):
            codes = ""
            for a in args.split(","):
                a = a.strip()
                codes += ("p" if "*" in a else "l" if "long long" in a
                          else "f" if a.startswith("float") else "i")
            out[(name, fn)] = codes
    return out


from ncf_tpu_torch.ops import _kernels, sampler, scatter, temporal_sum  # noqa: E402,E501
from ncf_tpu_torch.ops import gather, tower  # noqa: E402


@pytest.mark.parametrize("mod", (topk, sampler, scatter, temporal_sum))
def test_bindings_match_the_c_prototypes(mod):
    lib, fn, codes = mod.C_ENTRY
    assert _prototypes()[(lib, fn)] == codes


@pytest.mark.parametrize("entry", (tower.C_FWD, tower.C_BWD,
                                   topk.INT8_ENTRY, topk.EXACT_ENTRY,
                                   topk.SEGMAX_ENTRY, gather.C_ENTRY))
def test_tower_bindings_match_the_c_prototypes(entry):
    lib, fn, codes = entry
    assert _prototypes()[(lib, fn)] == codes


def test_wrappers_pass_what_the_bindings_declare(monkeypatch):
    """Drive each CUDA wrapper on CPU tensors with the launch recorded:
    the argument count and kinds must match the declared codes."""
    import contextlib

    calls = []

    def record(lib, fn, codes, *args):
        assert len(args) == len(codes), fn
        for c, a in zip(codes, args):
            assert (a is None or isinstance(a, (int, float))), (fn, c, a)
            assert isinstance(a, float) == (c == "f"), (fn, c, a)
            if c == "i":
                assert isinstance(a, int) and -2**31 <= a < 2**31, (fn, a)
        calls.append(fn)

    monkeypatch.setattr(_kernels, "launch", record)
    monkeypatch.setattr(_kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    u = torch.rand(2, 12)
    sampler._tree_sample_cuda(u, torch.zeros(3, dtype=torch.int32),
                              torch.linspace(0.1, 1.0, 50), 50, 4)
    scatter._scatter_cuda(torch.zeros(6, 2, dtype=torch.int32),
                          torch.zeros(6, 2, 8, dtype=torch.bfloat16), 9,
                          "split")
    temporal_sum._lookup_sum_cuda(torch.zeros(4, 5, dtype=torch.int32),
                                  [torch.zeros(r, 8) for r in (24, 7, 12,
                                                               365)])
    topk._streaming_cuda(torch.zeros(3, 16), torch.zeros(500, 16), None,
                         500, 10, 128, 2, 256)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: type("P", (), {"multi_processor_count": 4}))
    flat = [torch.zeros(8, 16), torch.zeros(16), torch.ones(16),
            torch.zeros(16)]
    x2 = torch.zeros(5, 8, dtype=torch.bfloat16)
    seed = torch.zeros(1, dtype=torch.int32)
    tower._fwd_cuda(x2, seed, flat, 0.2)
    tower._bwd_cuda(x2, torch.zeros(5, 16), seed, flat, 0.0)
    prep = topk.prepare_items_int8(torch.randn(500, 16), None,
                                   torch.randn(3, 16), block_items=128)
    topk._streaming_int8_cuda(topk._quantize_queries(torch.zeros(3, 16),
                                                     prep), prep, 10, 1)
    topk._exact_cuda(torch.zeros(3, 16), torch.zeros(500, 16), None, 10, 0)
    topk._segmax_cuda(torch.zeros(3, 16), torch.zeros(500, 16),
                      torch.zeros(500), 512, 128)
    gather._gather_cuda(torch.zeros(50, 8), torch.zeros(7, dtype=torch.long))
    assert calls == ["ncf_tree_sample", "ncf_scatter_add",
                     "ncf_temporal_sum", "ncf_topk_streaming",
                     "ncf_tower_fwd", "ncf_tower_bwd",
                     "ncf_topk_streaming_int8", "ncf_topk_exact",
                     "ncf_topk_segmax", "ncf_gather"]
