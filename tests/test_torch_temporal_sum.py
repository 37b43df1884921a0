"""Port parity for the fused temporal lookup-sum kernel B3: the plain
version's forward and its gradient (through ``torch.autograd``, whose
backward is the scatter kernel B2 in ``split`` mode) against the JAX
Pallas kernel run in interpret mode and ``jax.grad`` of it.

Tolerances: the forward is bit-identical (both add the four rows in
table order in f32; the one-hot products of the interpreted kernel are
exact on the CPU).  Gradients within 2e-6 of the per-element magnitude
sum ``sum |g|``: both round each element by the same ``split`` rule (or
none, for shapes the rule sends to an f32 scatter) and add in f32 in
another order.  Ids past the end are tested; negative ones are not,
because the reference's f32 fallback (``.at[ids].add`` below 2048 rows)
wraps them to the last row while its forward reads 0, and the port's
backward, like B2, drops them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.models import temporal as jtemporal  # noqa: E402
from ncf_tpu.ops.pallas_temporal import fused_lookup_sum as jfused  # noqa: E402
from ncf_tpu_torch.models import temporal as ttemporal  # noqa: E402
from ncf_tpu_torch.ops import temporal_sum as tts  # noqa: E402

ROWS = (24, 7, 12, 365)


def _inputs(B, dt, seed, bad_ids=True):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(r, dt)).astype(np.float32) for r in ROWS[:3]]
    tables.append(np.array(jtemporal.sinusoidal_table(dt)))
    ids = np.stack([rng.integers(0, r, B) for r in ROWS]).astype(np.int32)
    if bad_ids:                     # out of range: contributes 0
        ids[0, :3] = [24, 99, 24]
        ids[3, 3] = 365
    g = rng.normal(size=(B, dt)).astype(np.float32)
    return ids, tables, g


def _magnitude(ids_k, g, rows):
    keep = (ids_k >= 0) & (ids_k < rows)
    out = np.zeros((rows, g.shape[1]), np.float64)
    np.add.at(out, ids_k[keep], np.abs(g[keep]))
    return out


@pytest.mark.parametrize("B,dt", [(4096, 32), (300, 8), (2048, 16)])
def test_forward_and_gradient_match_pallas_interpret(B, dt):
    ids, tables, g = _inputs(B, dt, seed=B + dt)
    jt = tuple(jnp.asarray(t) for t in tables)
    want = np.asarray(jfused(jnp.asarray(ids), jt, True))
    jgrads = jax.grad(lambda ts: (jfused(jnp.asarray(ids), ts, True)
                                  * g).sum())(jt)

    tt = [torch.from_numpy(t).requires_grad_(k < 3)
          for k, t in enumerate(tables)]
    tts.fused_lookup_sum.launches.reset()
    out = tts.fused_lookup_sum(torch.from_numpy(ids), tt)
    assert out.dtype == torch.float32 and out.shape == (B, dt)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    (out * torch.from_numpy(g)).sum().backward()
    for k in range(3):
        tol = 2e-6 * _magnitude(ids[k], g, ROWS[k]) + 1e-30
        assert (np.abs(tt[k].grad.numpy() - np.asarray(jgrads[k]))
                <= tol).all()
    assert tt[3].grad is None                    # pe gets no gradient
    assert tts.fused_lookup_sum.launches.value == 0   # CPU: plain version


def test_plain_b3_equals_the_sum_of_lookups():
    ids, tables, _ = _inputs(500, 8, seed=1, bad_ids=False)
    got = tts.lookup_sum_ref(torch.from_numpy(ids),
                             [torch.from_numpy(t) for t in tables])
    want = ((tables[0][ids[0]] + tables[1][ids[1]]) + tables[2][ids[2]]
            ) + tables[3][ids[3]]
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_lookup_sum_checks_its_arguments():
    ids, tables, _ = _inputs(64, 8, seed=2)
    ts = [torch.from_numpy(t) for t in tables]
    with pytest.raises(ValueError):
        tts.fused_lookup_sum(torch.from_numpy(ids[:3]), ts)
    with pytest.raises(ValueError):
        tts.fused_lookup_sum(torch.from_numpy(ids),
                             ts[:3] + [torch.zeros(365, 4)])
    with pytest.raises(RuntimeError, match="no temporal kernel"):
        tts.fused_lookup_sum(torch.from_numpy(ids).to("meta"),
                             [t.to("meta") for t in ts])


def test_temporal_apply_takes_the_sum_of_lookups_on_the_cpu():
    # the fused branch is for 1-D ids of >= 4096 rows on the card; the
    # CPU keeps the plain lookups, which agree with the reference's
    B, dt = 4096, 16
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=(r, dt)).astype(np.float32)
              for k, r in zip(("hour", "day", "month"), ROWS)}
    cols = [rng.integers(0, r, B).astype(np.int32) for r in (24, 7, 12, 900)]
    want = np.asarray(jtemporal.apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        *[jnp.asarray(c) for c in cols]))
    tts.fused_lookup_sum.launches.reset()
    got = ttemporal.apply({k: torch.from_numpy(v) for k, v in params.items()},
                          *[torch.from_numpy(c) for c in cols])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tts.fused_lookup_sum.launches.value == 0
