"""Port parity for the scatter-add kernel B2 and the embedding lookup's
backward: the plain version against the sequential ``np.add.at`` in f32
(bit for bit) and against the JAX Pallas kernel
(``onehot_scatter_add(..., interpret=True)``) in each rounding mode, the
kernel's bookkeeping (``scatter._runs``) replayed in NumPy, the backward's
routing against ``ncf_tpu.ops.embedding``'s decision, and B7's backward.

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


@pytest.mark.parametrize("name", _CASES)
def test_kernel_bookkeeping_replays_the_plain_order(name):
    """What the kernel does with ``_runs``' output, replayed in NumPy: for
    each row, its run of sorted positions in order, each position's row of
    grads by the kernel's mapping, summed from 0.0 in f32."""
    ids, g, rows = _case(name, seed=7)
    sorted_ids, perm, r, slots = tscatter._runs(torch.from_numpy(ids))
    assert sorted_ids.dtype == torch.int32 and perm.dtype == torch.int64
    assert r * slots == ids.size
    sorted_ids, perm = sorted_ids.numpy(), perm.numpy()
    g2 = _rounded(g.reshape(-1, g.shape[-1]), "split")
    out = np.zeros((rows, g.shape[-1]), np.float32)
    for i in range(rows):
        lo, hi = np.searchsorted(sorted_ids, [i, i + 1])
        for f in perm[lo:hi]:
            e = f if slots == 1 else (f % r) * slots + f // r
            out[i] += g2[e]
    want = tscatter.scatter_add_ref(torch.from_numpy(ids),
                                    torch.from_numpy(g), rows, "split")
    assert np.array_equal(out.view(np.int32), want.numpy().view(np.int32))


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
