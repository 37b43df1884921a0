"""The port's CUDA kernels against their plain PyTorch versions.

The card tests carry the ``cuda`` marker and skip without a card.  This
file imports neither JAX nor the JAX package, so on a machine with a GPU
and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: values within 1e-5 * sum_d |q_d v_d| + 1e-6 (f32 sums in
another order); ids equal wherever the two rivals' exact scores differ
by more than that.
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
    # 5 segments of 64 -> 5 candidates; slots 5.. are empty: (NEG_INF, I-1)
    assert bool((kv[:, 5:] == torch.tensor(topk.NEG_INF)).all())
    assert bool((ki[:, 5:] == 299).all())
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


def test_streaming_raises_off_cpu_and_cuda():
    q = torch.zeros((2, 16), device="meta")
    t = torch.zeros((500, 16), device="meta")
    with pytest.raises(RuntimeError, match="no streaming kernel"):
        topk.topk_scores_streaming(q, t, k=5)
