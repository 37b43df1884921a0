"""Port parity for the exact (B8, ``topk_scores_pallas``) and segmented
(B9, ``topk_scores_segmented``) top-k kernels: their plain versions,
which CPU tensors take, against the JAX Pallas kernels in interpret mode,
and the dispatch's ``impl`` routes.

Tolerances: ids equal; values within rtol/atol 1e-5 (f32 sums in another
order).  The segmented kernel's per-segment keys are compared exactly:
they quantize scores that both packages compute to the same f32 bits at
these sizes.  Ties use small integers, exact in both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax.numpy as jnp  # noqa: E402

from ncf_tpu.ops import topk as jtopk  # noqa: E402
from ncf_tpu_torch.ops import topk as ttopk  # noqa: E402

NEG_INF = ttopk.NEG_INF


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


def _same(got, want):
    (tv, ti), (jv, ji) = got, want
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- B8

@pytest.mark.parametrize("case", [
    # (B, I, D, k, block_items, bias)
    (5, 500, 32, 10, 128, True),
    (3, 1537, 16, 64, 256, False),
    (16, 300, 8, 40, 16, True),       # block_items < k
    (4, 40, 8, 50, 16, False),        # k > I: empty slots
    (2, 2049, 16, 256, 2048, True),   # the largest k, the default block
])
def test_exact_topk_matches_the_reference(case):
    B, I, D, k, block, bias = case
    q, t, b = _data(B, I, D, bias, seed=I)
    want = jtopk.topk_scores_pallas(_j(q), _j(t), k=k, bias=_j(b),
                                    block_items=block, user_tile=8,
                                    interpret=True)
    _same(ttopk.topk_scores_pallas(_t(q), _t(t), k=k, bias=_t(b),
                                   block_items=block), want)
    _same(ttopk.topk_scores_pallas_ref(_t(q), _t(t), k=k, bias=_t(b),
                                       block_items=block), want)


def test_exact_topk_ties_prefer_the_lowest_id():
    want = jtopk.topk_scores_pallas(jnp.ones((4, 8)), jnp.ones((32, 8)), k=3,
                                    block_items=16, user_tile=4,
                                    interpret=True)
    got = ttopk.topk_scores_pallas(torch.ones(4, 8), torch.ones(32, 8), k=3,
                                   block_items=16)
    _same(got, want)
    np.testing.assert_array_equal(got[1].numpy(), np.tile([0, 1, 2], (4, 1)))
    rng = np.random.default_rng(1)
    q = rng.integers(-1, 2, (6, 8)).astype(np.float32)
    t = rng.integers(-1, 2, (700, 8)).astype(np.float32)
    _same(ttopk.topk_scores_pallas(_t(q), _t(t), k=30, block_items=128),
          jtopk.topk_scores_pallas(_j(q), _j(t), k=30, block_items=128,
                                   user_tile=8, interpret=True))


def test_exact_topk_empty_slots_repeat_the_reference_id():
    """Items whose bias is NEG_INF never surface; with fewer real scores
    than k the empty slots repeat the best item before the last block."""
    rng = np.random.default_rng(2)
    t = rng.normal(size=(40, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    b = np.full(40, NEG_INF, np.float32)
    b[[5, 30, 37]] = (1.0, 2.0, 3.0)
    want = jtopk.topk_scores_pallas(_j(q), _j(t), k=6, bias=_j(b),
                                    block_items=16, user_tile=8,
                                    interpret=True)
    got = ttopk.topk_scores_pallas(_t(q), _t(t), k=6, bias=_t(b),
                                   block_items=16)
    _same(got, want)
    assert (got[0].numpy()[:, 3:] == np.float32(NEG_INF)).all()


def test_exact_topk_caps_k():
    q, t, b = _data(2, 600, 8, False)
    with pytest.raises(ValueError, match="256"):
        ttopk.topk_scores_pallas(_t(q), _t(t), k=257)
    with pytest.raises(ValueError, match="256"):
        ttopk.topk_scores(_t(q), _t(t), k=300, impl="pallas")


# --------------------------------------------------------------- B9

@pytest.mark.parametrize("case", [
    # (B, I, D, k, block_items, seg_width, bias)
    (24, 5000, 32, 10, 512, 128, True),
    (24, 5000, 32, 10, 512, 8, True),
    (3, 1537, 16, 20, 256, 32, False),
    (9, 700, 8, 5, 128, 64, True),
])
def test_segmented_topk_matches_the_reference(case):
    B, I, D, k, block, seg, bias = case
    q, t, b = _data(B, I, D, bias, seed=I + seg)
    want = jtopk.topk_scores_segmented(_j(q), _j(t), k=k, bias=_j(b),
                                       block_items=block, user_tile=8,
                                       seg_width=seg, interpret=True)
    _same(ttopk.topk_scores_segmented(_t(q), _t(t), k=k, bias=_t(b),
                                      block_items=block, seg_width=seg),
          want)
    _same(ttopk.topk_scores_segmented_ref(_t(q), _t(t), k=k, bias=_t(b),
                                          block_items=block, seg_width=seg),
          want)


def test_segment_keys_match_the_reference_kernel():
    """The kernel's output itself: one packed key per (user, segment),
    padded segments included, in the reference's [B, segments] order."""
    import functools

    import jax

    B, I, D, block, seg = 8, 1000, 16, 256, 32
    q, t, b = _data(B, I, D, True, seed=3)
    ipad = -(-I // block) * block
    qj = _j(q)
    tj = jnp.pad(_j(t), ((0, ipad - I), (0, 0)))
    bj = jnp.zeros((1, ipad), jnp.float32).at[0, :I].set(_j(b))
    kern = functools.partial(jtopk._segmax_kernel, I, block, seg, 5)
    from jax.experimental import pallas as pl
    keys = pl.pallas_call(
        kern, grid=(1, ipad // block),
        in_specs=[pl.BlockSpec((B, D), lambda i, j: (i, 0)),
                  pl.BlockSpec((block, D), lambda i, j: (j, 0)),
                  pl.BlockSpec((1, block), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((B, block // seg), lambda i, j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((ipad // block * B, block // seg),
                                       jnp.int32),
        interpret=True)(qj, tj, bj)
    want = np.asarray(keys).reshape(ipad // block, B, block // seg)
    want = want.transpose(1, 0, 2).reshape(B, -1)
    got = ttopk.segmax_keys_ref(_t(q), _t(t), _t(b), block, seg)
    np.testing.assert_array_equal(got.numpy(), want)
    # equal quantized scores: the highest offset wins
    np.testing.assert_array_equal(
        ttopk._monotone_i32(torch.tensor([-2.0, -1.0, 0.0, 1.0])).numpy(),
        np.asarray(jtopk._monotone_i32(jnp.asarray([-2.0, -1.0, 0.0, 1.0]))))


# --------------------------------------------------------------- dispatch

def test_dispatch_routes_every_impl(monkeypatch):
    calls = []
    for name in ("topk_scores_dense", "topk_scores_xla",
                 "topk_scores_streaming", "topk_scores_pallas",
                 "topk_scores_segmented"):
        real = getattr(ttopk, name)
        monkeypatch.setattr(
            ttopk, name,
            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    q, t, b = _data(2, 3000, 16, True)
    for impl in ("pallas", "segmented", "dense", "xla", "streaming"):
        v, i = ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b), impl=impl)
        assert v.shape == i.shape == (2, 5)
    assert calls == ["topk_scores_pallas", "topk_scores_segmented",
                     "topk_scores_dense", "topk_scores_xla",
                     "topk_scores_streaming"]
    # the exact kernels agree with the dense path
    d = ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b), impl="dense")
    e = ttopk.topk_scores(_t(q), _t(t), k=5, bias=_t(b), impl="pallas")
    np.testing.assert_array_equal(e[1].numpy(), d[1].numpy())
