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
  comparisons, the same order of f32 additions);
- scatter-add (B2): within 1e-6 of the per-element magnitude sum
  ``sum |g|`` (f32 atomics add in an order that changes from run to run).

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


def _exact(q, table, bias, ids):
    qd = q.to(table.dtype).double()
    prod = qd[:, None, :] * table[ids.long()].double()
    s = prod.sum(-1) + (0 if bias is None else bias.double()[ids.long()])
    return s, 1e-5 * prod.abs().sum(-1) + 1e-6


def _assert_close(kv, ki, rv, ri, q, table, bias):
    valid = rv > topk.NEG_INF
    assert torch.equal(kv > topk.NEG_INF, valid)
    assert torch.equal(ki[~valid], ri[~valid])
    sk, tol_k = _exact(q, table, bias, ki)
    sr, tol_r = _exact(q, table, bias, ri)
    tol = torch.maximum(tol_k, tol_r)
    assert bool(((kv.double() - rv.double()).abs() <= tol)[valid].all())
    swap = (ki != ri) & valid
    assert bool(((sk - sr).abs() <= tol)[swap].all())


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 7, 64, 300))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("seg", ((128, 2), (64, 1), (32, 2)))
def test_streaming_kernel_matches_plain_version(cuda, B, dtype, seg):
    gen = torch.Generator(device=cuda).manual_seed(B)
    I = 100_003
    table = torch.randn((I, 64), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    bias = torch.randn((I,), generator=gen, device=cuda)
    q = torch.randn((B, 64), generator=gen, device=cuda)
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


@pytest.mark.cuda
@pytest.mark.parametrize("num_items", (100, 3706, 100_003))
@pytest.mark.parametrize("rounds", (1, 2))
def test_tree_sampler_kernel_equals_plain_version(cuda, num_items, rounds):
    from ncf_tpu_torch.ops import sampler

    gen = torch.Generator(device=cuda).manual_seed(num_items + rounds)
    w = torch.rand(num_items, generator=gen, device=cuda) + 1e-3
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    for B, NEG in ((16384, 4), (65536, 1), (37, 3)):
        u = torch.rand((rounds, B * NEG), generator=gen, device=cuda)
        u[0, :3] = torch.stack([cdf[0], cdf[-1], cdf[num_items // 2]])
        pos = torch.randint(-1, num_items, (B,), generator=gen, device=cuda,
                            dtype=torch.int32)
        n0 = sampler.tree_sample_negatives.launches.value
        got = sampler.tree_sample_negatives(u, pos, cdf, num_items)
        assert sampler.tree_sample_negatives.launches.value == n0 + 1
        pos_bn = pos[:, None].expand(B, NEG).reshape(-1)
        want = sampler.tree_sample_ref(u, pos_bn, cdf, num_items)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(-1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("split", "bf16", "f32"))
@pytest.mark.parametrize("shape,rows,d,dtype", [
    ((16384,), 6040, 128, "bfloat16"), ((16384, 5), 3706, 128, "bfloat16"),
    ((3706,), 9, 64, "float32"), ((16384,), 24, 32, "float32"),
    ((1000, 3), 77, 40, "float32")])
def test_scatter_kernel_matches_plain_version(cuda, mode, shape, rows, d,
                                              dtype):
    from ncf_tpu_torch.ops import scatter

    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    ids = torch.randint(-2, rows + 2, shape, generator=gen, device=cuda,
                        dtype=torch.int32)                 # some out of range
    g = torch.randn(shape + (d,), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    n0 = scatter.onehot_scatter_add.launches.value
    got = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
    assert scatter.onehot_scatter_add.launches.value == n0 + 1
    want = scatter.scatter_add_ref(ids, g, rows, mode)
    flat_ids, flat_g = scatter._flat(ids, g)
    keep = (flat_ids >= 0) & (flat_ids < rows)
    mag = torch.zeros((rows, d), device=cuda).index_add_(
        0, flat_ids[keep].long(), flat_g[keep].float().abs())
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    assert bool(((got - want).abs() <= 1e-6 * mag + 1e-30).all())


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
        cnt = ((ids[k] >= 0) & (ids[k] < rows[k])).long()
        want = torch.zeros(rows[k], device=cuda).index_add_(
            0, ids[k].clamp(0, rows[k] - 1), cnt.float())
        torch.cuda.synchronize()
        assert torch.allclose(ts[k].grad, want[:, None].expand(-1, 32),
                              rtol=0, atol=1e-6 * float(want.max()))


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


def test_streaming_raises_off_cpu_and_cuda():
    q = torch.zeros((2, 16), device="meta")
    t = torch.zeros((500, 16), device="meta")
    with pytest.raises(RuntimeError, match="no streaming kernel"):
        topk.topk_scores_streaming(q, t, k=5)


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
                          else "i")
            out[(name, fn)] = codes
    return out


from ncf_tpu_torch.ops import _kernels, sampler, scatter, temporal_sum  # noqa: E402,E501


@pytest.mark.parametrize("mod", (topk, sampler, scatter, temporal_sum))
def test_bindings_match_the_c_prototypes(mod):
    lib, fn, codes = mod.C_ENTRY
    assert _prototypes()[(lib, fn)] == codes


def test_wrappers_pass_what_the_bindings_declare(monkeypatch):
    """Drive each CUDA wrapper on CPU tensors with the launch recorded:
    the argument count and kinds must match the declared codes."""
    import contextlib

    calls = []

    def record(lib, fn, codes, *args):
        assert len(args) == len(codes), fn
        for c, a in zip(codes, args):
            assert (a is None or isinstance(a, int)), (fn, c, a)
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
    assert calls == ["ncf_tree_sample", "ncf_scatter_add",
                     "ncf_temporal_sum", "ncf_topk_streaming"]
