"""Port parity for the int8 retrieval tier (kernel B6): the PyTorch
``prepare_items_int8`` and the plain version of
``topk_scores_streaming_int8`` (which CPU tensors take) against the JAX
package, with its Pallas kernel in interpret mode; then the ``int8`` and
``int8-fast`` presets of ``AdvancedNCFScorer`` and
``SequenceRescoreScorer`` with the prepared path forced on the CPU in both
packages.

Tolerances: the prepared table, its scales and the int8 top-k (ids and
dequantized values) are equal bit for bit: the arithmetic is integer, and
the scales round as the reference's compiled code does.  The scorers are
given the JAX scorer's item vectors, query table and biases, so the int8
stage is identical too; their ids must be equal and their probabilities
within 1e-5 (the exact rescore and the bf16-tier exclusion path sum f32
products in another order, and the JAX package folds the bias of that
path into three bf16 matmul columns).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ncf_tpu.serving.scorer as jscorer  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.ops import topk as jtopk  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy  # noqa: E402
from ncf_tpu_torch.ops import topk as ttopk  # noqa: E402
from ncf_tpu_torch.serving import scorer as tscorer  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

NEG_INF = ttopk.NEG_INF
# (items, dim, block_items, seg_width): a catalog that does not divide
# the block, D + 3 not a multiple of 4, several blocks
TABLES = ((1000, 16, 256, 64), (1537, 61, 512, 128), (300, 64, 128, 32))


def _data(I, D, B=7, seed=0, bias_scale=3.0):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(I, D)).astype(np.float32)
    bias = (rng.normal(size=(I,)) * bias_scale).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    return items, bias, q


def _prepare(items, bias, q, **kw):
    jp = jtopk.prepare_items_int8(
        jnp.asarray(items), None if bias is None else jnp.asarray(bias),
        jnp.asarray(q), **kw)
    tp = ttopk.prepare_items_int8(
        torch.from_numpy(items), None if bias is None else
        torch.from_numpy(bias), torch.from_numpy(q), **kw)
    return jp, tp


def _assert_equal(got, want):
    (tv, ti), (jv, ji) = got, want
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("with_bias", (True, False))
@pytest.mark.parametrize("table", TABLES)
def test_prepare_items_int8_matches_the_reference(table, with_bias):
    I, D, block, seg = table
    items, bias, q = _data(I, D)
    jp, tp = _prepare(items, bias if with_bias else None, q,
                      block_items=block, seg_width=seg)
    assert tp.table.dtype == torch.int8
    assert tp.table.shape == (-(-I // block) * block, D + 3)
    np.testing.assert_array_equal(tp.table.numpy(), np.asarray(jp.table))
    np.testing.assert_array_equal(tp.col_scale.numpy(),
                                  np.asarray(jp.col_scale))
    assert tp.q_scale.numpy() == np.asarray(jp.q_scale)
    assert (tp.num_items, tp.dim, tp.block_items, tp.seg_width) == (
        jp.num_items, jp.dim, jp.block_items, jp.seg_width)
    ju, jb = jp.unfold()
    tu, tb = tp.unfold()
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_default_block_and_bias_digits():
    items, bias, q = _data(2000, 64, seed=3)
    jp, tp = _prepare(items, bias, q, seg_width=128)
    assert tp.block_items == jp.block_items == 8192
    b_int = np.arange(-32322, 32323, 97, dtype=np.float32)
    want = np.asarray(jtopk._bias_digits(jnp.asarray(b_int)))
    got = ttopk._bias_digits(torch.from_numpy(b_int)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got) <= 127).all()
    np.testing.assert_array_equal(127 * got[:, 0] + 127 * got[:, 1]
                                  + got[:, 2], b_int)


@pytest.mark.parametrize("k", (1, 10, 64))
@pytest.mark.parametrize("seg_top", (1, 2))
@pytest.mark.parametrize("table", TABLES)
def test_int8_topk_matches_the_reference_bit_for_bit(table, seg_top, k):
    I, D, block, seg = table
    items, bias, q = _data(I, D, seed=k)
    jp, tp = _prepare(items, bias, q, block_items=block, seg_width=seg)
    want = jtopk.topk_scores_streaming_int8(jnp.asarray(q), jp, k,
                                            seg_top=seg_top, interpret=True)
    got = ttopk.topk_scores_streaming_int8(torch.from_numpy(q), tp, k,
                                           seg_top=seg_top)
    _assert_equal(got, want)
    _assert_equal(ttopk.topk_scores_streaming_int8_ref(
        torch.from_numpy(q), tp, k, seg_top=seg_top), want)


def test_int8_ties_keep_the_reference_order():
    """Small integer tables: many equal integer scores across and within
    segments and blocks."""
    rng = np.random.default_rng(4)
    items = rng.integers(-1, 2, (700, 8)).astype(np.float32)
    bias = rng.integers(0, 2, 700).astype(np.float32)
    q = rng.integers(-1, 2, (5, 8)).astype(np.float32)
    jp, tp = _prepare(items, bias, q, block_items=128, seg_width=32)
    for seg_top in (1, 2):
        want = jtopk.topk_scores_streaming_int8(
            jnp.asarray(q), jp, 40, seg_top=seg_top, interpret=True)
        _assert_equal(ttopk.topk_scores_streaming_int8(
            torch.from_numpy(q), tp, 40, seg_top=seg_top), want)


def test_padded_rows_and_low_scores_come_back_empty():
    """Every real item scores below the padded rows' floor: the padded
    rows win, and every winner reports as an empty slot with its id
    clamped, as in the reference."""
    I, D = 300, 8
    items = np.full((I, D), -1.0, np.float32)
    items[:, 0] += np.linspace(0, 0.5, I, dtype=np.float32)
    bias = np.full((I,), -1e9, np.float32)
    q = np.ones((3, D), np.float32)
    jp, tp = _prepare(items, bias, q, block_items=256, seg_width=64)
    for seg_top in (1, 2):
        want = jtopk.topk_scores_streaming_int8(
            jnp.asarray(q), jp, 10, seg_top=seg_top, interpret=True)
        got = ttopk.topk_scores_streaming_int8(torch.from_numpy(q), tp, 10,
                                               seg_top=seg_top)
        _assert_equal(got, want)
        assert (got[0].numpy() == np.float32(NEG_INF)).all()
        assert (got[1].numpy() <= I - 1).all()


def test_fewer_candidates_than_k_take_the_fill_id():
    """One segment a block and k above the candidate count: the slots
    beyond the candidates take the carry's top-1, as in the reference."""
    items, bias, q = _data(200, 16, B=4, seed=8)
    jp, tp = _prepare(items, bias, q, block_items=64, seg_width=64)
    want = jtopk.topk_scores_streaming_int8(jnp.asarray(q), jp, 10,
                                            seg_top=2, interpret=True)
    got = ttopk.topk_scores_streaming_int8(torch.from_numpy(q), tp, 10,
                                           seg_top=2)
    _assert_equal(got, want)
    assert (got[0].numpy()[:, 8:] == np.float32(NEG_INF)).all()


def test_dispatch_routes_prepared_int8(monkeypatch):
    items, bias, q = _data(1000, 16, seed=5)
    jp, tp = _prepare(items, bias, q, block_items=256)
    tq = torch.from_numpy(q)
    # k <= 64: the int8 kernel, seg_top 1 by default
    _assert_equal(ttopk.topk_scores(tq, tp, 10),
                  jtopk.topk_scores_streaming_int8(jnp.asarray(q), jp, 10,
                                                   seg_top=1, interpret=True))
    # k > 64: the blocked exact path over the dequantized table
    tv, ti = ttopk.topk_scores(tq, tp, 80)
    jv, ji = jtopk.topk_scores(jnp.asarray(q), jp, 80)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="baked in"):
        ttopk.topk_scores(tq, tp, 10, bias=torch.from_numpy(bias))
    calls = []
    monkeypatch.setattr(ttopk, "topk_scores_streaming_int8",
                        lambda *a, **kw: calls.append(kw) or (None, None))
    ttopk.topk_scores(tq, tp, 10, seg_top=2)
    ttopk.topk_scores(tq, tp, 10)
    assert calls == [{"seg_top": 2}, {"seg_top": 1}]


def test_int8_refuses_what_the_reference_refuses():
    items, bias, q = _data(100, 16)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="power of two"):
        ttopk.prepare_items_int8(t(items), t(bias), t(q), seg_width=48)
    with pytest.raises(ValueError, match="multiple"):
        ttopk.prepare_items_int8(t(items), t(bias), t(q), block_items=96,
                                 seg_width=64)
    big = torch.zeros((4, 1025))
    with pytest.raises(ValueError, match="dim <= 1024"):
        ttopk.prepare_items_int8(big, None, big)
    tp = ttopk.prepare_items_int8(t(items), t(bias), t(q), block_items=128)
    with pytest.raises(ValueError, match="seg_top"):
        ttopk.topk_scores_streaming_int8(t(q), tp, 5, seg_top=3)


# --------------------------------------------------------------- scorers

USERS, ITEMS = 64, 2048
TEMPORAL = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}


def _cfgs(use_sequence=False):
    out = []
    for cfg in (JConfig(), Config()):
        m = cfg.model
        m.num_users, m.num_items = USERS, ITEMS
        m.mf_dim = m.mlp_dim = 16
        m.temporal_dim, m.mlp_hidden_dims = 8, [32, 16]
        m.compute_dtype, m.use_category = "float32", False
        m.use_sequence, m.history_len, m.num_heads = use_sequence, 6, 2
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    tree = jmodel.init(jax.random.PRNGKey(1), jcfg.model)
    return jcfg, tcfg, jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture
def forced(monkeypatch):
    """Both packages take the prepared path on the CPU: the JAX package as
    its own serving tests force it (interpret-mode kernels), the port by
    its gate constants.  The JAX scorer's jitted retrieval is retraced on
    both sides of the patch."""
    monkeypatch.setattr(jscorer, "_PREPARE_MIN_ITEMS", 1)
    monkeypatch.setattr(jscorer.jax, "default_backend", lambda: "tpu")
    real = jscorer.topk_scores

    def patched(q, items, k, bias=None, impl="auto", seg_top=None):
        if isinstance(items, jtopk.PreparedItemsInt8) and k <= 64:
            return jtopk.topk_scores_streaming_int8(
                q, items, k, seg_top=seg_top or 1, interpret=True)
        if isinstance(items, jtopk.PreparedItems) and k <= 64:
            return jtopk.topk_scores_streaming(
                q, items, k, seg_top=seg_top or 2, interpret=True)
        return real(q, items, k, bias=bias, impl=impl, seg_top=seg_top)

    monkeypatch.setattr(jscorer, "topk_scores", patched)
    monkeypatch.setattr(tscorer, "_PREPARE_MIN_ITEMS", 1)
    monkeypatch.setattr(tscorer, "_PREPARE_DEVICES", ("cuda", "cpu"))
    jscorer._take_topk.clear_cache()
    yield
    jscorer._take_topk.clear_cache()


def _share_tables(ts, js, contexts=(None,), hours=()):
    """The port's scorer takes the JAX scorer's item vectors, query table
    and biases, so both quantize the same numbers."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ts.item_vecs = t(js.item_vecs)
    ts.user_queries = t(js.user_queries)
    ts._q_maxabs = t(js._q_maxabs)
    for temporal in contexts:
        ts._bias_cache[tscorer._context_key(temporal)] = t(
            js.item_bias(temporal))
    for h in hours:
        ts._bias_cache[("hour_mod", h)] = t(js._hour_mod(h))
        ts._bias_cache[("hour_bias", h)] = t(js._hourly_item_bias(h))


def _same(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("preset", ("int8", "int8-fast"))
def test_int8_presets_match_the_reference_scorer(model, forced, preset):
    jcfg, tcfg, np_params = model
    js = jscorer.AdvancedNCFScorer(jax.tree.map(jnp.asarray, np_params),
                                   jcfg.model, retrieval=preset)
    ts = tscorer.AdvancedNCFScorer(params_from_numpy(np_params, "cpu"),
                                   tcfg.model, retrieval=preset)
    _share_tables(ts, js, (None, TEMPORAL), hours=(7,))
    users = np.asarray([0, 3, 17, 40, 63])
    _same(ts.topk_for_users(users, k=10), js.topk_for_users(users, k=10))
    _same(ts.topk_for_users(users, k=10, temporal=TEMPORAL),
          js.topk_for_users(users, k=10, temporal=TEMPORAL))
    # the hourly path quantizes against q_maxabs * |mod|
    _same(ts.topk_for_users_hourly(users, hour=7, k=10),
          js.topk_for_users_hourly(users, hour=7, k=10))
    prep = ts._prepared_cache[("hour_bias", 7)]
    np.testing.assert_array_equal(
        prep.table.numpy(), np.asarray(js._prepared_cache[("hour_bias", 7)]
                                       .table))
    assert all(isinstance(p, ttopk.PreparedItemsInt8)
               for p in ts._prepared_cache.values())
    # exclusions: 50 ids keep fetch = 60 <= 64; the 'int8' over-fetch then
    # passes the merge and takes the bf16 tier's prepared table (seg
    # 128/2), 'int8-fast' stays on the int8 table; 60 ids pass the merge
    # under both and take the blocked exact path on the raw table
    rng = np.random.default_rng(3)
    for width in (50, 60):
        exclude = rng.integers(0, ITEMS, (len(users), width)).astype(np.int32)
        exclude[:, :3] = ts.topk_for_users(users, k=3)[1]
        got = ts.topk_for_users(users, k=10, exclude=exclude)
        _same(got, js.topk_for_users(users, k=10, exclude=exclude))
        for r in range(len(users)):
            assert not set(exclude[r]) & set(got[1][r])
    fallback = ("bf16_fallback", ()) in ts._prepared_cache
    assert fallback == (preset == "int8")
    if fallback:
        assert isinstance(ts._prepared_cache[("bf16_fallback", ())],
                          ttopk.PreparedItems)


def test_int8_scores_are_exact_after_the_rescore(model, forced):
    """'int8' returns exact scores of its ids; 'int8-fast' dequantized
    ones."""
    jcfg, tcfg, np_params = model
    params = params_from_numpy(np_params, "cpu")
    exact = tscorer.AdvancedNCFScorer(params, tcfg.model, impl="dense")
    users = np.arange(0, USERS, 5)
    q = exact.user_queries[torch.as_tensor(users)]
    dense = (q @ exact.item_vecs.T + exact.item_bias()[None, :]).numpy()
    ref = 1 / (1 + np.exp(-dense.astype(np.float64)))
    for preset in ("int8", "int8-fast"):
        s, i = tscorer.AdvancedNCFScorer(params, tcfg.model,
                                         retrieval=preset).topk_for_users(
            users, k=10)
        want = np.take_along_axis(ref, i.astype(np.int64), axis=1)
        err = np.abs(s - want).max()
        assert err <= 1e-6 if preset == "int8" else err > 1e-6
        assert (np.diff(s, axis=1) <= 1e-7).all()
        overlap = np.mean([len(set(i[r]) & set(np.argsort(-dense[r])[:10]))
                           / 10 for r in range(len(users))])
        assert overlap >= 0.5


@pytest.fixture(scope="module")
def seq_model():
    jcfg, tcfg = _cfgs(use_sequence=True)
    tree = jmodel.init(jax.random.PRNGKey(2), jcfg.model)
    rng = np.random.default_rng(9)
    hist = rng.integers(0, ITEMS, (USERS, 6)).astype(np.int32)
    hist[::3, 4:] = -1
    return jcfg, tcfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                    tree), hist


@pytest.mark.parametrize("preset", ("int8", "int8-fast"))
def test_int8_presets_in_the_sequence_scorer(seq_model, forced, preset):
    """Stage 1 takes the int8 table (fetch 64), or, past the merge, the
    reference's dequantized unfold; stage 2 rescores exactly."""
    jcfg, tcfg, np_params, hist = seq_model
    js = jscorer.SequenceRescoreScorer(
        jax.tree.map(jnp.asarray, np_params), jcfg.model, user_history=hist,
        sample_users=32, retrieval=preset)
    ts = tscorer.SequenceRescoreScorer(
        params_from_numpy(np_params, "cpu"), tcfg.model, user_history=hist,
        sample_users=32, retrieval=preset)
    _share_tables(ts, js, (None, TEMPORAL))
    users = np.asarray([1, 9, 30, 62])
    _same(ts.topk_for_users(users, k=10), js.topk_for_users(users, k=10))
    _same(ts.topk_for_users(users, k=10, temporal=TEMPORAL),
          js.topk_for_users(users, k=10, temporal=TEMPORAL))
    exclude = np.random.default_rng(4).integers(
        0, ITEMS, (len(users), 60)).astype(np.int32)
    _same(ts.topk_for_users(users, k=10, exclude=exclude),
          js.topk_for_users(users, k=10, exclude=exclude))
    assert isinstance(ts._prepared_cache[()], ttopk.PreparedItemsInt8)
