"""The arithmetic of kernel B1 (``csrc/tree_sampler.cu``), replayed in
NumPy on the CPU.

A block takes ``kThreads * kSlots`` consecutive slots, probes the CDF at
``kThreads`` evenly spaced entries, brackets every answer of its run
between two probes from its least and greatest uniform, and searches only
that bracket: staged when it holds at most ``kStaged`` entries, in device
memory above.  Sorted uniforms (the stratified sampler's pooled draw)
give small brackets, iid uniforms the whole CDF.  The replay is held, id
for id (``==``), against ``np.searchsorted(cdf, u, "right")`` clipped,
against the JAX Pallas sampler (interpret mode) and against the port's
plain version, in the cases the kernel must keep bit-identical: runs of
equal CDF values (zero-weight items), uniforms on a boundary, uniforms at
or above ``cdf[-1]`` (clipped), duplicate sorted uniforms, N not a
multiple of the slots a thread, N smaller than one block, and catalogs
above the 12,288 items a block stages.  The constants are read from the
kernel's source.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.ops.pallas_sampler import tree_sample_negatives as jtree  # noqa: E402
from ncf_tpu_torch.data import sampler as tsampler  # noqa: E402
from ncf_tpu_torch.ops import sampler as tops  # noqa: E402


def _constants():
    path = os.path.join(os.path.dirname(tops.__file__), "csrc",
                        "tree_sampler.cu")
    with open(path) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return {k: int(v) for k, v in consts.items()}


K = _constants()
THREADS, SLOTS, STAGED = K["kThreads"], K["kSlots"], K["kStaged"]
RUN = THREADS * SLOTS


def _count_le(c, u):
    """The kernel's branchless upper-bound search of fixed length over a
    nondecreasing ``c``, for every element of ``u``."""
    cnt = np.zeros(u.shape, np.int64)
    n = length = c.shape[0]
    while length > 1:
        half = length >> 1
        cnt += np.where(c[cnt + half - 1] <= u, half, 0)
        length -= half
    if length == 1 and n:
        cnt += c[cnt] <= u
    return cnt


def _finish(d, u, num_items):
    d = np.where(u == u, d, 0)                 # NaN counts nothing
    return np.minimum(d, num_items - 1)


def _reject(cands, pos_bn):
    pick = cands[-1]
    for r in range(cands.shape[0] - 2, -1, -1):
        pick = np.where(cands[r] != pos_bn, cands[r], pick)
    return pick


def _bracket(cdf, vals):
    """(lo, hi) of a block whose uniforms are ``vals``: every answer is
    lo + #{i in [lo, hi) : cdf[i] <= u}."""
    n = cdf.shape[0]
    stride = -(-n // THREADS)
    probes = cdf[::stride]
    real = vals[vals == vals]
    lo_u = real.min() if real.size else np.float32(np.inf)
    hi_u = real.max() if real.size else np.float32(-np.inf)
    below = int((probes <= lo_u).sum())
    upto = int((probes <= hi_u).sum())
    lo = (below - 1) * stride + 1 if below > 0 else 0
    hi = upto * stride if upto < probes.shape[0] else n
    return lo, max(hi, lo)


def kernel_replay(u, pos_bn, cdf, num_items):
    """The kernel on u [R, N]: ids [N] and each block's bracket."""
    R, N = u.shape
    cands = np.empty((R, N), np.int64)
    brackets = []
    for b0 in range(0, N, RUN):
        run = u[:, b0:b0 + RUN]
        lo, hi = _bracket(cdf, run.reshape(-1))
        brackets.append((lo, hi))
        cands[:, b0:b0 + RUN] = _finish(lo + _count_le(cdf[lo:hi], run), run,
                                        num_items)
    return _reject(cands, pos_bn), brackets


def _cdf(n, seed, zero_runs=False):
    rng = np.random.default_rng(seed)
    w = 1.0 / rng.zipf(1.3, n).astype(np.float64)
    if zero_runs:                        # zero-weight items: equal entries
        w[rng.random(n) < 0.3] = 0.0
        w[n // 3:n // 3 + 50] = 0.0
        w[-20:] = 0.0                    # cdf[-1] repeated at the end
    # the port's CDF: a sequential f32 sum on the CPU, nondecreasing as
    # the kernel's search (and the TPU kernel's tree) requires
    cdf = tsampler.make_sampling_cdf(w).numpy()
    assert (np.diff(cdf) >= 0).all()
    return cdf


def _uniforms(case, cdf, N, rng):
    """One round of N uniforms for ``case``, sorted."""
    u = rng.random(N, dtype=np.float32)
    if case == "boundaries":             # every tenth uniform on an entry
        u[::10] = cdf[rng.integers(0, cdf.shape[0], u[::10].shape[0])]
    elif case == "clipped":              # at and above cdf[-1]
        k = N // 8
        u[N - k:] = np.float32(cdf[-1]) + rng.random(k, dtype=np.float32)
        u[:3] = cdf[-1]
    elif case == "duplicates":           # runs of equal uniforms
        u = np.repeat(u[:-(-N // 7)], 7)[:N]
    return np.sort(u)


CASES = [  # (case, num_items, N, zero-weight runs)
    ("random", 3706, 65536, False),      # the pooled draw at ML-1M
    ("boundaries", 3706, 20000, True),
    ("clipped", 1682, 9999, False),      # N % 4 != 0
    ("duplicates", 3706, 4099, True),
    ("random", 3706, 1001, False),       # N < one block
    ("random", 3706, 3, False),
    ("boundaries", 20000, 5000, True),   # above 12,288 items
    ("random", 40000, 700, False),       # one block: a bracket too wide
]


@pytest.mark.parametrize("case,num_items,N,zeros", CASES)
def test_sorted_route_replay_equals_the_reference(case, num_items, N, zeros):
    cdf = _cdf(num_items, num_items + N, zeros)
    rng = np.random.default_rng(N)
    u = _uniforms(case, cdf, N, rng)[None]
    no_pos = np.full(N, -1, np.int64)
    want = np.minimum(np.searchsorted(cdf, u[0], "right"), num_items - 1)
    got, brackets = kernel_replay(u, no_pos, cdf, num_items)
    np.testing.assert_array_equal(got, want)
    assert len(brackets) == -(-N // RUN)
    if case == "random" and N == 65536:
        # the pooled draw: each block stages a small stretch of the CDF
        assert max(hi - lo for lo, hi in brackets) <= 256
    if N == 700:
        assert brackets[0][1] - brackets[0][0] > STAGED  # device memory
    pallas = jtree(jnp.asarray(u), jnp.full((N,), -1, jnp.int32),
                   jnp.asarray(cdf), num_items, interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas).reshape(-1), want)
    plain = tops.tree_sample_ref(torch.from_numpy(u),
                                 torch.from_numpy(no_pos).int(),
                                 torch.from_numpy(cdf), num_items)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("sort", (True, False))
@pytest.mark.parametrize("num_items", (3706, 20000))
def test_both_routes_reject_the_positive_as_the_reference(sort, num_items):
    """Two rounds with positives, on both ways through the kernel: sorted
    uniforms, and iid ones (the iid draw), which give every block nearly
    the whole CDF as its bracket, staged at ML-1M's 3,706 items and
    searched in device memory at 20,000.  The ids stay the reference's."""
    cdf = _cdf(num_items, 3, zero_runs=True)
    rng = np.random.default_rng(num_items)
    B, NEG = 1031, 4
    u = rng.random((2, B * NEG), dtype=np.float32)
    if sort:
        u = np.sort(u, axis=1)
    u[0, :4] = [cdf[0], cdf[-1], np.nextafter(cdf[9], 0), 1.5]
    pos = rng.integers(0, num_items, B).astype(np.int32)
    first = np.minimum(np.searchsorted(cdf, u[0], "right"), num_items - 1)
    pos[:50] = first[:200:4]             # rejection bites
    pos_bn = np.repeat(pos, NEG)
    pallas = np.asarray(jtree(jnp.asarray(u), jnp.asarray(pos),
                              jnp.asarray(cdf), num_items,
                              interpret=True)).reshape(-1)
    got, brackets = kernel_replay(u, pos_bn, cdf, num_items)
    np.testing.assert_array_equal(got, pallas)
    if not sort:
        for lo, hi in brackets:
            assert hi - lo > num_items * 0.9
            assert (hi - lo <= STAGED) == (num_items <= STAGED)
    plain = tops.tree_sample_negatives(
        torch.from_numpy(u), torch.from_numpy(pos), torch.from_numpy(cdf),
        num_items)
    np.testing.assert_array_equal(plain.numpy().reshape(-1), pallas)


def test_nan_and_infinite_uniforms_count_as_the_plain_version():
    cdf = _cdf(500, 9)
    u = np.array([[np.nan, -np.inf, 0.0, np.inf, np.nan, 0.5]], np.float32)
    no_pos = np.full(6, -1, np.int64)
    plain = tops.tree_sample_ref(torch.from_numpy(u),
                                 torch.from_numpy(no_pos).int(),
                                 torch.from_numpy(cdf), 500).numpy()
    np.testing.assert_array_equal(kernel_replay(u, no_pos, cdf, 500)[0], plain)
    every_nan = np.full((1, 9), np.nan, np.float32)
    got, brackets = kernel_replay(every_nan, np.full(9, -1), cdf, 500)
    assert not got.any() and brackets[0][0] == brackets[0][1]


def test_inverse_cdf_gives_the_plain_result_on_cpu():
    cdf = _cdf(3706, 1, zero_runs=True)
    rng = np.random.default_rng(5)
    u = _uniforms("boundaries", cdf, 8192, rng)
    want = np.minimum(np.searchsorted(cdf, u, "right"), 3705)
    tc = torch.from_numpy(cdf)
    tops.tree_sample_negatives.launches.reset()
    got = tsampler._inverse_cdf(tc, torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(jsampler._inverse_cdf(jnp.asarray(cdf), jnp.asarray(u)))
    np.testing.assert_array_equal(want, ref)
    # on the CPU the stratified sampler's pooled draw launches nothing
    negs = tsampler.sample_negatives_stratified(
        None, torch.arange(2048) % 3706, 3706, 4, tc,
        sorted_u=torch.from_numpy(u), rot=17)
    assert negs.shape == (2048, 4)
    assert tops.tree_sample_negatives.launches.value == 0


def test_the_pooled_draw_gives_each_block_a_small_bracket():
    """The stratified sampler's own pooled uniforms at the training step's
    size (16,384 rows x 4 negatives over ML-1M's 3,706 items) ascend, so
    each block of the kernel stages a short stretch of the CDF; the
    replay's ids are ``_inverse_cdf``'s."""
    cdf = _cdf(3706, 11)
    gen = torch.Generator().manual_seed(3)
    u = tsampler.stratified_uniforms(gen, 65536).numpy()
    assert (np.diff(u) >= 0).all()
    got, brackets = kernel_replay(u[None], np.full(65536, -1), cdf, 3706)
    assert len(brackets) == 65536 // RUN
    assert max(hi - lo for lo, hi in brackets) <= 256
    assert sum(hi - lo for lo, hi in brackets) < 3 * 3706
    want = tsampler._inverse_cdf(torch.from_numpy(cdf), torch.from_numpy(u))
    np.testing.assert_array_equal(got, want.numpy())


def test_ordered_for_marks_where_a_search_and_the_count_agree():
    """``ordered_for`` against its definition, pair by pair, on a CDF
    that falls in three places."""
    c = np.array([0.1, 0.3, 0.2, 0.25, 0.4, 0.5, 0.45, 0.9], np.float32)
    u = np.array([0.05, 0.15, 0.2, 0.22, 0.26, 0.3, 0.35, 0.44, 0.46, 0.5,
                  0.95, np.nan], np.float32)
    want = [not any(c[i] > x >= c[j] for i in range(8)
                    for j in range(i + 1, 8)) for x in u]
    got = tops.ordered_for(torch.from_numpy(u), torch.from_numpy(c))
    assert got.tolist() == want
    assert tops.ordered_for(torch.from_numpy(u),
                            torch.from_numpy(np.sort(c))).all()


@pytest.mark.parametrize("sort", (True, False))
def test_replay_on_a_falling_cdf_equals_the_count_where_ordered(sort):
    """Outside the kernel's contract: a CDF that falls by a few ulps at a
    few entries, as a parallel scan on the card can sum it.  The bracket
    and the search still give the plain count for every uniform the CDF
    is ordered for; in the gaps the count and any search part."""
    cdf = _cdf(6000, 4)
    falls = (3, 777, 3000, 5001)
    for i in falls:
        cdf[i] = np.nextafter(np.nextafter(cdf[i + 1], 2), 2)
    assert (np.diff(cdf) < 0).sum() == 4
    rng = np.random.default_rng(8)
    u = rng.random(9000, dtype=np.float32)
    for k, i in enumerate(falls):                    # some in each gap
        u[k * 50:(k + 1) * 50] = cdf[i + 1]
    if sort:
        u = np.sort(u)
    no_pos = np.full(u.shape[0], -1, np.int64)
    got, _ = kernel_replay(u[None], no_pos, cdf, 6000)
    tu, tc = torch.from_numpy(u[None]), torch.from_numpy(cdf)
    plain = tops.tree_sample_ref(tu, torch.from_numpy(no_pos).int(), tc,
                                 6000).numpy()
    keep = tops.ordered_for(tu, tc).numpy()[0]
    assert 200 <= (~keep).sum() < 1000
    np.testing.assert_array_equal(got[keep], plain[keep])
    search = np.minimum(np.searchsorted(cdf, u, "right"), 5999)
    assert (search[~keep] != plain[~keep]).any()
