"""Port parity for negative sampling: kernel B1's plain version against
the JAX Pallas sampler (interpret mode) and ``_inverse_cdf``, and the
port's iid and stratified samplers fed the reference's own random
numbers.

Tolerances: ids must be equal (``==``) given the same uniforms and CDF.
``make_sampling_cdf`` agrees to atol 1e-6: ``jnp.cumsum`` and
``torch.cumsum`` may add in another order, so the last bits of an f32
prefix sum may differ (the ids are then held on one shared CDF).  The
port's stratified uniforms sum their spacings in int64 fixed point: equal
bit for bit to that sum taken in NumPy, and within 1e-5 of the
reference's f32 formula on the same uniforms (f32 prefix sums of 4,096
spacings).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.ops.pallas_sampler import tree_sample_negatives as jtree  # noqa: E402
from ncf_tpu_torch.data import sampler as tsampler  # noqa: E402
from ncf_tpu_torch.ops import sampler as tops  # noqa: E402


def _cdf(n, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / rng.zipf(1.3, n).astype(np.float64)
    return np.array(jsampler.make_sampling_cdf(w)), w


def _where_chain(cands, pos):
    pick = cands[-1]
    for r in range(cands.shape[0] - 2, -1, -1):
        pick = np.where(cands[r] != pos, cands[r], pick)
    return pick


@pytest.mark.parametrize("num_items", (100, 3706, 40000))
@pytest.mark.parametrize("rounds", (1, 2))
@pytest.mark.parametrize("no_pos", (False, True))
def test_plain_b1_equals_the_reference(num_items, rounds, no_pos):
    cdf, _ = _cdf(num_items, num_items)
    rng = np.random.default_rng(rounds)
    B, NEG = 257, 4
    u = rng.random((rounds, B * NEG), dtype=np.float32)
    u[0, :5] = [0.0, cdf[0], cdf[-1], np.nextafter(cdf[7], 0), cdf[7]]
    pos = (np.full(B, -1, np.int32) if no_pos
           else rng.integers(0, num_items, B).astype(np.int32))
    # rejection bites: some first draws are the row's positive
    if not no_pos:
        first = np.asarray(jsampler._inverse_cdf(jnp.asarray(cdf),
                                                 jnp.asarray(u[0])))
        pos[:40] = first[:160:4]
    got = tops.tree_sample_negatives(torch.from_numpy(u), torch.from_numpy(pos),
                                     torch.from_numpy(cdf), num_items)
    assert got.dtype == torch.int32 and got.shape == (B, NEG)
    cands = np.asarray(jsampler._inverse_cdf(jnp.asarray(cdf),
                                             jnp.asarray(u)))
    want = _where_chain(cands, np.repeat(pos, NEG)).reshape(B, NEG)
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = jtree(jnp.asarray(u), jnp.asarray(pos), jnp.asarray(cdf),
                   num_items, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_plain_b1_takes_three_dim_uniforms_and_counts_nothing_on_cpu():
    cdf, _ = _cdf(500, 1)
    u = np.random.default_rng(2).random((2, 33, 3), dtype=np.float32)
    pos = np.arange(33, dtype=np.int32)
    tops.tree_sample_negatives.launches.reset()
    flat = tops.tree_sample_negatives(torch.from_numpy(u.reshape(2, -1)),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(cdf), 500)
    three = tops.tree_sample_negatives(torch.from_numpy(u),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(cdf), 500)
    assert torch.equal(flat, three)
    assert tops.tree_sample_negatives.launches.value == 0
    with pytest.raises(ValueError):
        tops.tree_sample_negatives(torch.from_numpy(u[:, :32]),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(cdf), 500)


@pytest.mark.parametrize("num_items", (100, 3706))
def test_make_sampling_cdf(num_items):
    want, w = _cdf(num_items, 4)
    got = tsampler.make_sampling_cdf(w).numpy()
    assert got.dtype == np.float32 and got[-1] == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("num_items,weighted", [(100, True), (3706, True),
                                                (3706, False)])
@pytest.mark.parametrize("rounds", (1, 2))
def test_iid_sampler_equals_the_reference(num_items, weighted, rounds):
    cdf, _ = _cdf(num_items, 8)
    key = jax.random.PRNGKey(num_items + rounds)
    rng = np.random.default_rng(0)
    B, NEG = 300, 4
    pos = rng.integers(0, num_items, B).astype(np.int32)
    jcdf = jnp.asarray(cdf) if weighted else None
    want = np.asarray(jsampler.sample_negatives(
        key, jnp.asarray(pos), num_items, NEG, cdf=jcdf, num_rounds=rounds))
    if not weighted:                  # uniform ids come from each RNG
        got = tsampler.sample_negatives(
            torch.Generator().manual_seed(0), torch.from_numpy(pos),
            num_items, NEG, num_rounds=rounds)
        assert got.shape == want.shape and got.dtype == torch.int32
        assert ((got >= 0) & (got < num_items)).all()
        return
    u = np.array(jax.random.uniform(key, (rounds, B, NEG), jnp.float32))
    got = tsampler.sample_negatives(
        None, torch.from_numpy(pos), num_items, NEG,
        cdf=torch.from_numpy(cdf), num_rounds=rounds, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_iid_sampler_with_history_equals_the_reference():
    num_items, B, NEG, R, H = 60, 50, 3, 4, 6
    cdf, _ = _cdf(num_items, 9)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, num_items, B).astype(np.int32)
    hist = rng.integers(0, num_items, (B, H)).astype(np.int32)
    hist[:, 4:] = -1
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsampler.sample_negatives(
        key, jnp.asarray(pos), num_items, NEG, cdf=jnp.asarray(cdf),
        history=jnp.asarray(hist), num_rounds=R))
    u = np.array(jax.random.uniform(key, (R, B, NEG), jnp.float32))
    got = tsampler.sample_negatives(
        None, torch.from_numpy(pos), num_items, NEG, cdf=torch.from_numpy(cdf),
        history=torch.from_numpy(hist), num_rounds=R, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_items,weighted", [(100, True), (3706, True),
                                                (3706, False), (40000, True)])
@pytest.mark.parametrize("rounds", (1, 2, 3))
def test_stratified_sampler_equals_the_reference(num_items, weighted, rounds):
    cdf, _ = _cdf(num_items, 6)
    key = jax.random.PRNGKey(rounds)
    rng = np.random.default_rng(rounds)
    B, NEG = 256, 4
    N = B * NEG
    pos = rng.integers(0, num_items, B).astype(np.int32)
    jcdf = jnp.asarray(cdf) if weighted else None
    want = np.asarray(jsampler.sample_negatives_stratified(
        key, jnp.asarray(pos), num_items, NEG, cdf=jcdf, num_rounds=rounds))
    # the reference's random numbers (sampler.py:124-128, :144)
    u = jax.random.uniform(key, (N + 1,), jnp.float32, minval=1e-7,
                           maxval=1.0)
    s = jnp.cumsum(-jnp.log(u))
    sorted_u = np.array(s[:N] / s[N])
    rot = int(jax.random.randint(key, (), 0, N, dtype=jnp.int32))
    got = tsampler.sample_negatives_stratified(
        None, torch.from_numpy(pos), num_items, NEG,
        cdf=torch.from_numpy(cdf) if weighted else None, num_rounds=rounds,
        sorted_u=torch.from_numpy(sorted_u), rot=rot)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stratified_uniforms_sum_spacings_in_fixed_point():
    n = 4096
    got = tsampler.stratified_uniforms(torch.Generator().manual_seed(3), n)
    u = tsampler._uniform(torch.Generator().manual_seed(3), (n + 1,), None,
                          1e-7, 1.0)
    e = (-torch.log(u)).double().numpy()
    spacing = np.round(e * 2.0 ** 32).astype(np.int64)
    s = np.cumsum(spacing)
    assert s[-1] == spacing[::-1].sum()            # any order, same sum
    want = (s[:n].astype(np.float64) / float(s[n])).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    s32 = jnp.cumsum(-jnp.log(jnp.asarray(u.numpy())))
    ref = np.asarray(s32[:n] / s32[n])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_stratified_uniforms_are_sorted_and_seeded():
    a = tsampler.stratified_uniforms(torch.Generator().manual_seed(1), 4096)
    b = tsampler.stratified_uniforms(torch.Generator().manual_seed(1), 4096)
    assert torch.equal(a, b)
    assert bool((a[1:] >= a[:-1]).all()) and 0.0 < float(a[0])
    assert float(a[-1]) < 1.0
    # order statistics of uniforms: the median sits near 0.5
    assert abs(float(a[2048]) - 0.5) < 0.05
