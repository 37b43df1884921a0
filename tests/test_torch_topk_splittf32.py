"""The arithmetic of the tensor-core tile of B5, B8 and B9, emulated on
the CPU.

``csrc/topk_common.cuh`` scores f32 tables by split-TF32: each operand x
splits into ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)``, and
``lo.hi + hi.lo + hi.hi`` accumulate in f32, one ``mma.sync`` (8 deep) at
a time; a bf16 table with f32 queries takes ``t.lo + t.hi``; bf16 by bf16
one bf16 product (16 deep).  The emulation below repeats that: rounding
to nearest with ties away from zero at 10 mantissa bits, exact products,
each instruction's sum added to the f32 accumulator and rounded.

Held here: every route within the callers' tolerance ``1e-5 * sum_d
|q_d v_d| + 1e-6`` of the f64 score (``chip_smoke.py::compare_topk``,
``tests/test_torch_kernels.py``) on layer-normed vectors like the
bigvocab tables at D 64 and 61 and on adversarial magnitudes (entries of
1e-3 and 1e3, cancellation); bit for bit on small integers (the tie
tests); the top-k of the emulated scores against the port's plain exact
top-k; and one TF32 product failing the same tolerance, which is why the
tile pays for three.

B9 packs the tile's scores into one key per segment (the quantized score
above the offset).  Its keys from the emulated ``split3`` and ``split2``
scores are held against the JAX Pallas kernel's keys (interpret mode,
``_segmax_kernel``) under the rule of ``topk.segmax_key_violations``
(stated in ``csrc/topk_segmax.cu``): where a key differs, the plain winner i_P and the tile's winner i_K
scored in f64 must satisfy ``s(i_P) - s(i_K) <= seg_width * ulp(|s(i_P)|
+ 2 eps) + 2 eps`` with ``eps = 1e-5 * max sum_d |q_d v_d| + 1e-6``.  On
small integers the keys are equal bit for bit; one TF32 product breaks
the rule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ncf_tpu.ops import topk as jtopk  # noqa: E402
from ncf_tpu_torch.ops import topk  # noqa: E402

F32, F64 = np.float32, np.float64


def _tf32(x):
    """f32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero (``cvt.rna.tf32.f32``), kept as f32."""
    b = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32((x.astype(F32) - hi).astype(F32))


def _bf16(x):
    """f32 -> bf16 (round to nearest even), kept as f32."""
    return torch.from_numpy(np.asarray(x, F32)).to(torch.bfloat16).float() \
        .numpy()


def _pad(x, kp):
    return np.pad(x, ((0, 0), (0, kp - x.shape[1])))


def _mma(pairs, kstep, B, I, bias):
    """pairs of (table operand [I, KP], query operand [B, KP]) in the
    tile's order; each ``kstep``-deep instruction adds its exact sum to
    the f32 accumulator, then the bias is added in f32."""
    acc = np.zeros((B, I), F32)
    kp = pairs[0][0].shape[1]
    for k0 in range(0, kp, kstep):
        sl = slice(k0, k0 + kstep)
        for a, b in pairs:
            step = b[:, sl].astype(F64) @ a[:, sl].astype(F64).T
            acc = (acc.astype(F64) + step).astype(F32)
    return (acc + bias[None, :]).astype(F32) if bias is not None else acc


def tile_scores(q, t, bias, route):
    """[B, I] scores as the tile computes them.  route: "split3" (f32
    table and queries), "split2" (bf16 table, f32 queries), "bf16" (both
    bf16), "tf32" (one TF32 product: what the tile does NOT do)."""
    B, D = q.shape
    I = t.shape[0]
    if route in ("split3", "tf32"):
        kp = -(-D // 8) * 8
        th, tl = _split(_pad(t, kp))
        qh, ql = _split(_pad(q, kp))
        pairs = [(tl, qh), (th, ql), (th, qh)] if route == "split3" \
            else [(th, qh)]
        return _mma(pairs, 8, B, I, bias)
    kp = -(-D // 16) * 16
    tb = _pad(_bf16(t), kp)
    if route == "split2":
        qh, ql = _split(_pad(q, kp))
        return _mma([(tb, ql), (tb, qh)], 8, B, I, bias)
    return _mma([(tb, _pad(_bf16(q), kp))], 16, B, I, bias)


def _operands(route, q, t):
    """The values the route multiplies (bf16 tables and queries are
    rounded first, as the kernels receive them)."""
    if route in ("split2", "bf16"):
        t = _bf16(t)
    if route == "bf16":
        q = _bf16(q)
    return q, t


def _layernormed(rng, n, d):
    x = rng.standard_normal((n, d))
    x = (x - x.mean(1, keepdims=True)) / np.sqrt(x.var(1, keepdims=True)
                                                 + 1e-6)
    scale = 1.0 + 0.1 * rng.standard_normal(d)
    return (x * scale + 0.1 * rng.standard_normal(d)).astype(F32)


def _case(name, B=16, I=640):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("layernorm64", "layernorm61"):
        d = 64 if name == "layernorm64" else 61
        q, t = _layernormed(rng, B, d), _layernormed(rng, I, d)
    elif name == "mixed":                  # entries of 1e-3 and 1e3
        def draw(n):
            mag = np.where(rng.random((n, 64)) < 0.5, 1e-3, 1e3)
            return (mag * rng.choice([-1.0, 1.0], (n, 64))
                    * (1 + 0.5 * rng.random((n, 64)))).astype(F32)
        q, t = draw(B), draw(I)
    else:                                  # cancellation: sums near zero
        q = rng.standard_normal((B, 32)).astype(F32)
        q = np.concatenate([q, q], 1)
        a = rng.standard_normal((I, 32)).astype(F32)
        t = np.concatenate(
            [a, -a * (1 + 1e-4 * rng.standard_normal((I, 32)))], 1
        ).astype(F32)
    bias = rng.standard_normal(I).astype(F32)
    return q, t, bias


def _f64(q, t, bias):
    prod = q.astype(F64)[:, None, :] * t.astype(F64)[None, :, :]
    return prod.sum(-1) + bias.astype(F64)[None, :], np.abs(prod).sum(-1)


CASES = ("layernorm64", "layernorm61", "mixed", "cancellation")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ("split3", "split2", "bf16"))
def test_tile_scores_are_within_the_tolerance(case, route):
    q, t, bias = _case(case)
    got = tile_scores(q, t, bias, route)
    s, mag = _f64(*_operands(route, q, t), bias)
    assert got.dtype == F32 and got.shape == s.shape
    assert bool((np.abs(got - s) <= 1e-5 * mag + 1e-6).all())


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_product_fails_the_tolerance(case):
    q, t, bias = _case(case)
    s, mag = _f64(q, t, bias)
    one = tile_scores(q, t, bias, "tf32")
    assert not bool((np.abs(one - s) <= 1e-5 * mag + 1e-6).all())
    three = tile_scores(q, t, bias, "split3")
    assert np.abs(three - s).max() < np.abs(one - s).max() / 50


@pytest.mark.parametrize("route", ("split3", "split2", "bf16"))
def test_small_integers_are_exact(route):
    """Integers split with lo = 0: the scores, and so every tie, are
    exact, as the kernels' tie tests need."""
    rng = np.random.default_rng(7)
    q = rng.integers(-2, 3, (17, 16)).astype(F32)
    t = rng.integers(-2, 3, (900, 16)).astype(F32)
    bias = rng.integers(0, 2, 900).astype(F32)
    for x in (q, t):
        hi, lo = _split(x)
        assert np.array_equal(hi, x) and not lo.any()
    got = tile_scores(q, t, bias, route)
    want = (q.astype(np.int64) @ t.astype(np.int64).T + bias.astype(
        np.int64)).astype(F32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("route", ("split3", "split2"))
def test_tile_top_k_matches_the_plain_exact_top_k(case, route):
    """The top-10 of the emulated scores against ``topk_scores_pallas_ref``
    (B8's plain version) on the same inputs: values within the
    tolerance, ids equal wherever the rivals' exact scores differ by more."""
    q, t, bias = _case(case, B=8, I=3000)
    qt, tt = _operands(route, q, t)
    got = torch.from_numpy(tile_scores(q, t, bias, route))
    gv, gi = torch.sort(got, dim=1, descending=True, stable=True)
    gv, gi = gv[:, :10], gi[:, :10]
    table = torch.from_numpy(t)
    if route == "split2":
        table = table.to(torch.bfloat16)
    rv, ri = topk.topk_scores_pallas_ref(torch.from_numpy(q), table, 10,
                                         torch.from_numpy(bias))
    s, mag = _f64(qt, tt, bias)
    s, mag = torch.from_numpy(s), torch.from_numpy(mag)
    sg, sr = s.gather(1, gi.long()), s.gather(1, ri.long())
    tol = 1e-5 * torch.maximum(mag.gather(1, gi.long()),
                               mag.gather(1, ri.long())) + 1e-6
    assert bool(((gv.double() - rv.double()).abs() <= tol).all())
    swap = gi.int() != ri
    assert bool(((sg - sr).abs() <= tol)[swap].all())


# ---------------------------------------------------- B9's segment keys

def _pack_keys(scores, block, seg):
    """[B, Ipad / seg] keys of [B, I] f32 scores, the catalog padded to
    ``block`` with NEG_INF scores, as the kernel packs them."""
    B, I = scores.shape
    ipad = -(-I // block) * block
    s = np.full((B, ipad), np.float32(topk.NEG_INF), F32)
    s[:, :I] = scores
    i = s.view(np.int32)
    mono = i ^ ((i >> 31) & np.int32(0x7FFFFFFF))
    keys = (mono & np.int32(-seg)) | (np.arange(ipad, dtype=np.int32)
                                      & np.int32(seg - 1))
    return keys.reshape(B, -1, seg).max(axis=2)


def _reference_keys(q, t, bias, block, seg):
    """The JAX kernel's keys (``_segmax_kernel`` in interpret mode), in
    the [B, segments] order the port returns."""
    import functools

    B, I = q.shape[0], t.shape[0]
    ipad = -(-I // block) * block
    tj = jnp.pad(jnp.asarray(t), ((0, ipad - I), (0, 0)))
    bj = jnp.zeros((1, ipad), jnp.float32)
    if bias is not None:
        bj = bj.at[0, :I].set(jnp.asarray(bias))
    kern = functools.partial(jtopk._segmax_kernel, I, block, seg,
                             int(seg - 1).bit_length())
    keys = pl.pallas_call(
        kern, grid=(1, ipad // block),
        in_specs=[pl.BlockSpec((B, q.shape[1]), lambda i, j: (i, 0)),
                  pl.BlockSpec((block, q.shape[1]), lambda i, j: (j, 0)),
                  pl.BlockSpec((1, block), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((B, block // seg), lambda i, j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((ipad // block * B, block // seg),
                                       jnp.int32),
        interpret=True)(jnp.asarray(q), tj, bj)
    return (np.asarray(keys).reshape(ipad // block, B, block // seg)
            .transpose(1, 0, 2).reshape(B, -1))


def key_violations(q, t, bias, got, want, seg):
    """(keys that differ, of them those outside B9's rule), by the port's
    one statement of the rule, ``topk.segmax_key_violations``."""
    def tt(x):
        return None if x is None else torch.from_numpy(np.asarray(x))

    return topk.segmax_key_violations(tt(q), tt(t), tt(bias), tt(got),
                                      tt(want), seg)


@pytest.mark.parametrize("seg", (32, 64, 128))
@pytest.mark.parametrize("with_bias", (True, False))
@pytest.mark.parametrize("route", ("split3", "split2"))
def test_tile_segment_keys_are_within_the_tolerance(seg, with_bias, route):
    block = 256                           # 640 items: 128 padded rows
    differ = 0
    for case in CASES:
        q, t, bias = _case(case)
        bias = bias if with_bias else None
        qt, tt = _operands(route, q, t)
        got = _pack_keys(tile_scores(q, t, bias, route), block, seg)
        want = _reference_keys(qt, tt, bias, block, seg)
        assert got.shape == want.shape == (16, 768 // seg)
        np.testing.assert_array_equal(got[:, 640 // seg:],
                                      want[:, 640 // seg:])
        n, bad = key_violations(qt, tt, bias, got, want, seg)
        assert bad == 0, (case, n, bad)
        differ += n
    # the rule is exercised: the tile's sums move some keys
    assert differ > 0


@pytest.mark.parametrize("seg", (32, 64, 128))
@pytest.mark.parametrize("route", ("split3", "split2"))
def test_small_integer_segment_keys_are_exact(seg, route):
    rng = np.random.default_rng(seg)
    q = rng.integers(-2, 3, (9, 16)).astype(F32)
    t = rng.integers(-2, 3, (1000, 16)).astype(F32)
    bias = rng.integers(0, 2, 1000).astype(F32)
    for b in (bias, None):
        got = _pack_keys(tile_scores(q, t, b, route), 512, seg)
        np.testing.assert_array_equal(got, _reference_keys(q, t, b, 512, seg))
        plain = topk.segmax_keys_ref(torch.from_numpy(q), torch.from_numpy(t),
                                     None if b is None else torch.from_numpy(b),
                                     512, seg)
        np.testing.assert_array_equal(got, plain.numpy())


def test_one_tf32_product_moves_keys_beyond_the_tolerance():
    """Positive entries (no cancellation, so eps is as small as it gets
    against the scores) and short rows: one TF32 product picks a winner
    whose exact score falls short by more than the rule allows in a few
    segments (3 of 2,048 here), the split-TF32 tile in none: near-ties
    are rare, so the rule alone would let a single product through on
    most data."""
    rng = np.random.default_rng(0)
    q = rng.uniform(1, 2, (16, 4)).astype(F32)
    t = rng.uniform(1, 2, (4096, 4)).astype(F32)
    want = _reference_keys(q, t, None, 512, 32)
    one = _pack_keys(tile_scores(q, t, None, "tf32"), 512, 32)
    three = _pack_keys(tile_scores(q, t, None, "split3"), 512, 32)
    assert key_violations(q, t, None, one, want, 32)[1] > 0
    assert key_violations(q, t, None, three, want, 32)[1] == 0
