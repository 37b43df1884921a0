"""Port parity for ops/topk.py: the PyTorch streaming top-k (its plain
version, which CPU tensors take) against the JAX Pallas kernel run in
interpret mode, plus the dense/blocked/rescore paths and the dispatch.

Tolerances: ids must be equal; values within rtol/atol 1e-5, because the
JAX kernel adds the bias as three bf16 matmul columns, in another order
than the port's f32 epilogue.  Most inputs are continuous random draws;
the tie tests use small integers, whose scores both packages compute
exactly, so tied ids must come out in the reference's order.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax.numpy as jnp  # noqa: E402

from ncf_tpu.ops import topk as jtopk  # noqa: E402
from ncf_tpu_torch.ops import topk as ttopk  # noqa: E402

NEG_INF = ttopk.NEG_INF
CASES = list(itertools.product(
    (3, 16), (1000, 1537), (16, 64), ((128, 2), (64, 1)), (True, False)))


def _data(B, I, D, bias, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    t = rng.normal(size=(I, D)).astype(np.float32)
    b = rng.normal(size=(I,)).astype(np.float32) if bias else None
    return q, t, b


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_streaming(q, t, b, k, seg_width, seg_top):
    v, i = jtopk.topk_scores_streaming(
        _j(q), _j(t), k=k, bias=_j(b), block_items=256,
        seg_width=seg_width, seg_top=seg_top, interpret=True)
    return np.asarray(v), np.asarray(i)


def _assert_matches_jax(tv, ti, jv, ji, num_items):
    tv, ti = tv.numpy(), ti.numpy()
    valid = jv > NEG_INF
    np.testing.assert_array_equal(ti[valid], ji[valid])
    np.testing.assert_allclose(tv[valid], jv[valid], rtol=1e-5, atol=1e-5)
    # slots beyond the candidates: NEG_INF and the reference's id in both
    assert (tv[~valid] == np.float32(NEG_INF)).all()
    np.testing.assert_array_equal(ti[~valid], ji[~valid])
    assert (ti < num_items).all()


@pytest.mark.parametrize("B,I,D,seg,bias", CASES)
def test_streaming_matches_pallas_interpret(B, I, D, seg, bias):
    seg_width, seg_top = seg
    q, t, b = _data(B, I, D, bias, seed=B * I + D)
    jv, ji = _jax_streaming(q, t, b, 10, seg_width, seg_top)
    prep = ttopk.prepare_items(_t(t), _t(b), block_items=256,
                               seg_width=seg_width)
    for k in (1, 5, 10):
        # top-k of the candidates: every k is a prefix of k=10
        raw = ttopk.topk_scores_streaming(
            _t(q), _t(t), k=k, bias=_t(b), block_items=256,
            seg_width=seg_width, seg_top=seg_top)
        _assert_matches_jax(*raw, jv[:, :k], ji[:, :k], I)
        pv, pi = ttopk.topk_scores_streaming(_t(q), prep, k=k,
                                             seg_top=seg_top)
        np.testing.assert_array_equal(pi.numpy(), raw[1].numpy())
        np.testing.assert_array_equal(pv.numpy(), raw[0].numpy())


@pytest.mark.parametrize("k,seg", [(1, (128, 2)), (5, (64, 1)),
                                   (1, (64, 1)), (5, (128, 2))])
def test_streaming_small_k_matches_pallas_directly(k, seg):
    q, t, b = _data(16, 1537, 64, True, seed=k)
    jv, ji = _jax_streaming(q, t, b, k, *seg)
    tv, ti = ttopk.topk_scores_streaming_ref(
        _t(q), _t(t), k=k, bias=_t(b), block_items=256,
        seg_width=seg[0], seg_top=seg[1])
    _assert_matches_jax(tv, ti, jv, ji, 1537)


def test_streaming_misses_same_segment_items_like_pallas():
    # three winners in one 128-segment: seg_top=2 surfaces only two, in
    # both packages (exact top-k would return all three)
    q, t, b = _data(2, 1000, 16, False, seed=5)
    scale = np.asarray([[3.0], [3.03], [3.06]], np.float32)
    t[300:303] = q[0] * scale
    t[700:703] = q[1] * scale
    jv, ji = _jax_streaming(q, t, None, 5, 128, 2)
    tv, ti = ttopk.topk_scores_streaming(_t(q), _t(t), k=5, seg_width=128,
                                         seg_top=2)
    _assert_matches_jax(tv, ti, jv, ji, 1000)
    assert len({300, 301, 302} & set(ti[0].tolist())) == 2


@pytest.mark.parametrize("block_items", (256, 512, 1024))
@pytest.mark.parametrize("seg", ((128, 1), (64, 1), (128, 2)))
def test_streaming_empty_slots_take_the_reference_id(block_items, seg):
    # fewer candidates than k: the reference fills the rest with the
    # carry's top-1 entering the last item block (0 with one block)
    q, t, b = _data(5, 1000, 16, True, seed=block_items + seg[0])
    b[rng_items(1000, 400, seed=seg[1])] = NEG_INF     # empty some segments
    k = 40
    jv, ji = jtopk.topk_scores_streaming(
        _j(q), _j(t), k=k, bias=_j(b), block_items=block_items,
        seg_width=seg[0], seg_top=seg[1], interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert (jv <= NEG_INF).any()
    tv, ti = ttopk.topk_scores_streaming(
        _t(q), _t(t), k=k, bias=_t(b), block_items=block_items,
        seg_width=seg[0], seg_top=seg[1])
    _assert_matches_jax(tv, ti, jv, ji, 1000)
    prep = ttopk.prepare_items(_t(t), _t(b), block_items=block_items,
                               seg_width=seg[0])
    pv, pi = ttopk.topk_scores_streaming(_t(q), prep, k=k, seg_top=seg[1])
    _assert_matches_jax(pv, pi, jv, ji, 1000)


def rng_items(n, m, seed):
    return np.random.default_rng(seed).choice(n, m, replace=False)


@pytest.mark.parametrize("seg", ((128, 2), (64, 1), (32, 2)))
@pytest.mark.parametrize("block_items", (256, 512))
def test_streaming_ties_follow_the_reference_merge_order(seg, block_items):
    # small integer operands: exact scores with many ties across blocks,
    # ranks and segments
    rng = np.random.default_rng(seg[0] + block_items)
    q = rng.integers(-1, 2, (6, 8)).astype(np.float32)
    t = rng.integers(-1, 2, (1500, 8)).astype(np.float32)
    b = rng.integers(0, 2, 1500).astype(np.float32)
    jv, ji = jtopk.topk_scores_streaming(
        _j(q), _j(t), k=30, bias=_j(b), block_items=block_items,
        seg_width=seg[0], seg_top=seg[1], interpret=True)
    tv, ti = ttopk.topk_scores_streaming(
        _t(q), _t(t), k=30, bias=_t(b), block_items=block_items,
        seg_width=seg[0], seg_top=seg[1])
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert len(np.unique(jv[0])) < 10                  # the data does tie
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_streaming_on_cpu_leaves_the_launch_counter_alone():
    q, t, b = _data(3, 1000, 16, True)
    ttopk.topk_scores_streaming.launches.reset()
    ttopk.topk_scores_streaming(_t(q), _t(t), k=5, bias=_t(b))
    ttopk.topk_scores(_t(q), ttopk.prepare_items(_t(t), _t(b)), k=5)
    assert ttopk.topk_scores_streaming.launches.value == 0


def test_streaming_bf16_table_matches_pallas_interpret():
    q, t, b = _data(8, 1000, 16, True, seed=11)
    tb = jnp.asarray(t, jnp.bfloat16)
    jv, ji = jtopk.topk_scores_streaming(
        _j(q), tb, k=10, bias=_j(b), block_items=256, seg_width=64,
        seg_top=1, interpret=True)
    tv, ti = ttopk.topk_scores_streaming(
        _t(q), _t(t).to(torch.bfloat16), k=10, bias=_t(b), seg_width=64,
        seg_top=1)
    _assert_matches_jax(tv, ti, np.asarray(jv), np.asarray(ji), 1000)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_and_blocked_match_jax(bias):
    q, t, b = _data(5, 3000, 16, bias, seed=3)
    jv, ji = jtopk.topk_scores_dense(_j(q), _j(t), k=12, bias=_j(b))
    for fn in (ttopk.topk_scores_dense, ttopk.topk_scores_xla):
        tv, ti = fn(_t(q), _t(t), k=12, bias=_t(b))
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=1e-5, atol=1e-5)
    xv, xi = jtopk.topk_scores_xla(_j(q), _j(t), k=12, bias=_j(b),
                                   block_items=512)
    tv, ti = ttopk.topk_scores_xla(_t(q), _t(t), k=12, bias=_t(b),
                                   block_items=512)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))


def test_ties_go_to_the_lower_index():
    q = np.ones((2, 4), np.float32)
    t = np.ones((40, 4), np.float32)
    jv, ji = jtopk.topk_scores_dense(_j(q), _j(t), k=7)
    for fn in (ttopk.topk_scores_dense, ttopk.topk_scores_xla):
        _, ti = fn(_t(q), _t(t), k=7)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_rescore_exact_matches_jax():
    q, t, b = _data(4, 500, 16, True, seed=9)
    cand = np.random.default_rng(1).integers(0, 500, (4, 9)).astype(np.int32)
    jv, ji = jtopk.rescore_exact(_j(q), _j(t), _j(b), jnp.asarray(cand))
    tv, ti = ttopk.rescore_exact(_t(q), _t(t), _t(b), torch.from_numpy(cand))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_prepared_items_unfold_is_exact():
    q, t, b = _data(2, 1000, 16, True)
    prep = ttopk.prepare_items(_t(t), _t(b), block_items=256)
    assert prep.table.shape == (1024, 16) and prep.bias.shape == (1024,)
    assert (prep.bias[1000:] == np.float32(NEG_INF)).all()
    assert (prep.table[1000:] == 0).all()
    raw, rb = prep.unfold()
    assert torch.equal(raw, _t(t)) and torch.equal(rb, _t(b))
    jraw, jb = jtopk.prepare_items(_j(t), _j(b), block_items=256).unfold()
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    np.testing.assert_allclose(rb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_prepared_guards():
    t = torch.ones((600, 16))
    q = torch.ones((4, 16))
    prep = ttopk.prepare_items(t, None, block_items=256)
    with pytest.raises(ValueError):
        ttopk.topk_scores_streaming(q, prep, k=5, bias=torch.ones(600))
    with pytest.raises(ValueError):
        ttopk.topk_scores_streaming(q, prep, k=5, seg_width=64)
    with pytest.raises(ValueError):
        ttopk.topk_scores_streaming(q, prep, k=5, seg_top=3)
    with pytest.raises(ValueError):
        ttopk.prepare_items(t, None, block_items=100)


def test_dispatch_prepared_large_k_unfolds_to_blocked_path():
    q, t, b = _data(4, 3000, 16, True, seed=11)
    jprep = jtopk.prepare_items(_j(t), _j(b), block_items=512)
    jv, ji = jtopk.topk_scores(_j(q), jprep, k=100)
    prep = ttopk.prepare_items(_t(t), _t(b), block_items=512)
    tv, ti = ttopk.topk_scores(_t(q), prep, k=100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_dispatch_routes(monkeypatch):
    calls = []
    for name in ("topk_scores_dense", "topk_scores_xla",
                 "topk_scores_streaming"):
        real = getattr(ttopk, name)
        monkeypatch.setattr(
            ttopk, name,
            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    q, t, b = _data(2, 1000, 16, True)
    prep = ttopk.prepare_items(_t(t), _t(b))
    ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b))
    ttopk.topk_scores(_t(q), prep, k=5)
    ttopk.topk_scores(_t(q), prep, k=65)
    ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b), impl="streaming")
    ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b), impl="xla")
    assert calls == ["topk_scores_dense", "topk_scores_streaming",
                     "topk_scores_xla", "topk_scores_streaming",
                     "topk_scores_xla"]
    # a large catalog off the card takes the blocked path, never the kernel
    calls.clear()
    big_q = torch.zeros((4096, 16))
    monkeypatch.setattr(ttopk, "topk_scores_xla",
                        lambda *a, **kw: calls.append("xla"))
    ttopk.topk_scores(big_q, torch.zeros((4097, 16)), k=5)
    assert calls == ["xla"]
    for impl in ("pallas", "segmented"):
        with pytest.raises(NotImplementedError):
            ttopk.topk_scores(_t(q), _t(t), k=5, impl=impl)
    with pytest.raises(NotImplementedError):
        ttopk.prepare_items_int8(_t(t), None, _t(q))

