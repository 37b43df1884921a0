"""The port's exchange and sharded sparse update against the JAX
package's mesh functions.

The JAX side runs on the 8-virtual-device CPU mesh of this process
(``make_mesh(devices=jax.devices()[:n])``); the port's side runs as 2 or
4 gloo ranks on the CPU (``ncf_tpu_torch.parallel.workers``, a
``file://`` store under ``tmp_path``), with inputs and outputs passed as
``.npz`` files made from a seed.  Rank ``r`` of a ``(dcn, ici)`` mesh
holds the batch slice ``r`` (dcn-major), as device ``r`` of the
reference's ``P(('dcn', 'ici'))`` does.

- ``_bucket_by_owner``: send buffers and slots equal to the reference's,
  at exact capacity and at a positive capacity factor on a skewed stream
  (ids over capacity sent to the dummy slot).
- ``exchange_lookup``: the forward bit-equal to the reference's at
  ``(1, 2)`` and ``(2, 2)`` (and zeros for overflowing ids at a positive
  factor), the table gradient against ``jax.grad`` of the reference's
  within rtol 1e-6; ``ShardedEmbedding`` likewise.
- The routing collision: a replicated table with the shard's row count
  is not routed; the shard, named, is.
- ``sharded_sparse_rowwise_adagrad_update`` with given per-occurrence
  gradients at ``(1, 2)`` and ``(2, 2)``: each rank's routed and combined
  totals bit-equal to the reference's ``_route_combine`` on its device;
  tables and accumulators within rtol 1e-6 / atol 1e-7 of the
  reference's (``tests/test_torch_sparse.py``'s one-step tolerance),
  untouched rows bit-equal; with the clip off, bit-equal to the port's
  own one-process update.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ncf_tpu.parallel import embedding_sharding as jes  # noqa: E402
from ncf_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ncf_tpu.train import sparse_sharded as jss  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.parallel.embedding_sharding import (  # noqa: E402
    SENTINEL, _bucket_by_owner)
from ncf_tpu_torch.ops import embedding as temb  # noqa: E402
from ncf_tpu_torch.train import sparse as tsparse  # noqa: E402


def _jmesh(dcn, ici):
    return jmake_mesh(dcn=dcn, ici=ici, devices=jax.devices()[:dcn * ici])


@pytest.mark.parametrize("capacity,skew", [(None, False), (3, True),
                                           (5, False)])
def test_bucket_by_owner_matches_reference(capacity, skew):
    rng = np.random.default_rng(11)
    E, R, n = 4, 16, 24
    ids = (rng.integers(0, 8, n) if skew else rng.integers(0, E * R, n))
    C = n if capacity is None else capacity
    js, jslot = jes._bucket_by_owner(jnp.asarray(ids, jnp.int32), E, R, C)
    ts, tslot = _bucket_by_owner(torch.from_numpy(ids), E, R, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    if skew:
        assert (tslot.numpy() == E * C).sum() > 0      # some overflow
        assert (ts.numpy() == SENTINEL).sum() > 0


def _exchange_inputs(tmp_path, world, skew, seed=0):
    rng = np.random.default_rng(seed)
    N, D, n = 8 * world, 4, 12
    ids = (rng.integers(0, 4, (world, n)) if skew
           else rng.integers(0, N, (world, n)))
    arrays = {"table": rng.normal(size=(N, D)).astype(np.float32),
              "ids": ids.astype(np.int64),
              "g": rng.normal(size=(world, n, D)).astype(np.float32),
              "small": rng.normal(size=(N // (world if world < 4 else 2),
                                        D)).astype(np.float32)}
    arrays["small_ids"] = rng.integers(0, arrays["small"].shape[0],
                                       (world, 5))
    return arrays


@pytest.mark.parametrize("dcn,ici,cf", [(1, 2, 0.0), (2, 2, 0.0),
                                        (1, 2, 1.0)])
def test_exchange_lookup_matches_reference(tmp_path, dcn, ici, cf):
    world = dcn * ici
    a = _exchange_inputs(tmp_path, world, skew=cf > 0)
    # the small table has the shard's rows: the routing must tell them
    # apart by name
    a["small"] = a["small"][:a["table"].shape[0] // ici]
    a["small_ids"] = a["small_ids"] % a["small"].shape[0]
    io = str(tmp_path / "io")
    workers.save_inputs(io, a, {"capacity_factor": cf})
    workers.run("exchange", world, io, dcn=dcn, device="cpu")
    outs = [workers.load_outputs(io, r)[0] for r in range(world)]

    mesh = _jmesh(dcn, ici)
    ids = jnp.asarray(a["ids"].reshape(-1), jnp.int32)
    g = jnp.asarray(a["g"].reshape(-1, a["g"].shape[-1]))
    table = jnp.asarray(a["table"])
    # jitted: the reference's shard_map runs op by op otherwise (slow)
    jout = jax.jit(lambda t: jes.exchange_lookup(mesh, t, ids, cf))(table)
    jgrad = jax.jit(jax.grad(lambda t: jnp.sum(
        jes.exchange_lookup(mesh, t, ids, cf) * g)))(table)
    got = np.concatenate([o["out"] for o in outs])
    np.testing.assert_array_equal(got, np.asarray(jout))
    if cf > 0:
        assert (np.abs(got).sum(1) == 0).any()          # overflow: zeros
    # the table's gradient: the ici shards of dcn replica 0
    tgrad = np.concatenate([outs[i]["grad"] for i in range(ici)])
    np.testing.assert_allclose(tgrad, np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)
    for d in range(dcn):                     # the replicas agree exactly
        for i in range(ici):
            np.testing.assert_array_equal(outs[d * ici + i]["grad"],
                                          outs[i]["grad"])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["routed"], o["out"])
        np.testing.assert_array_equal(o["plain"],
                                      a["small"][a["small_ids"][r]])
        np.testing.assert_array_equal(o["unnamed"], o["plain"])
    if dcn == 1 and cf == 0:
        # the reference's ShardedEmbedding at capacity factor 4
        se = jes.ShardedEmbedding(mesh, table.shape[0], table.shape[1],
                                  capacity_factor=4.0)
        sids = jax.device_put(ids, se.batch_sharding)
        sout = jax.jit(lambda t: se.lookup(t, sids))(se.shard(table))
        sgrad = jax.jit(jax.grad(lambda t: jnp.sum(se.lookup(t, sids) * g)))(
            se.shard(table))
        np.testing.assert_array_equal(
            np.concatenate([o["se_out"] for o in outs]), np.asarray(sout))
        np.testing.assert_allclose(
            np.concatenate([o["se_grad"] for o in outs]), np.asarray(sgrad),
            rtol=1e-6, atol=1e-7)


def test_routing_is_by_name_not_by_rows():
    """In one process with a stand-in two-rank mesh: a registered shard's
    rows are recognized under its name only."""
    class Stand:
        shape = {"dcn": 1, "ici": 2}
        ici_index = 1

    temb.set_exchange(Stand(), {"user_emb": 10})
    try:
        shard = torch.zeros(5, 3)
        assert temb.shard_rows("user_emb", shard) == slice(5, 10)
        assert temb.shard_rows("temporal", shard) is None
        assert temb.shard_rows("user_emb", torch.zeros(10, 3)) is None
        assert temb.shard_rows(None, shard) is None
        small = torch.arange(15.0).reshape(5, 3)
        np.testing.assert_array_equal(
            temb.embedding_lookup(small, torch.tensor([4, 0])).numpy(),
            small.numpy()[[4, 0]])
    finally:
        temb.clear_exchange()
    assert temb.get_exchange() is None


def _sparse_inputs(world, seed):
    rng = np.random.default_rng(seed)
    Vu, Vi, d, nu, ni = 16, 24, 8, 8, 20
    a = {"user_table": rng.normal(size=(Vu, d)).astype(np.float32),
         "item_table": rng.normal(size=(Vi, d)).astype(np.float32),
         "user_acc": rng.random(Vu).astype(np.float32),
         "item_acc": rng.random(Vi).astype(np.float32),
         # a skewed item stream (sorted batches put a rank's ids on few
         # shards), duplicates across and within ranks
         "user_ids": rng.integers(0, Vu, (world, nu)),
         "item_ids": np.sort(rng.integers(0, Vi // 2, (world, ni)), axis=1),
         "user_g": rng.normal(size=(world, nu, d)).astype(np.float32),
         "item_g": rng.normal(size=(world, ni, d)).astype(np.float32)}
    return a


def _jax_route_combine(mesh, ids, g, R, C, G, E):
    ax = ("dcn", "ici")
    fn = jax.shard_map(
        lambda i, gg: jss._route_combine(i, gg, E, R, C, G), mesh=mesh,
        in_specs=(P(ax), P(ax, None)), out_specs=(P(ax), P(ax, None)),
        check_vma=False)
    rep, tot = jax.jit(fn)(jnp.asarray(ids, jnp.int32), jnp.asarray(g))
    return np.asarray(rep), np.asarray(tot)


@pytest.mark.parametrize("dcn,ici", [(1, 2), (2, 2)])
def test_sharded_sparse_update_matches_reference(tmp_path, dcn, ici):
    world = dcn * ici
    a = _sparse_inputs(world, seed=dcn * 10 + ici)
    lr, eps, wd, dense_sq = 0.05, 1e-8, 0.01, 2.0
    clips = [0.0, 0.5]
    io = str(tmp_path / "io")
    workers.save_inputs(io, a, {"lr": lr, "eps": eps, "weight_decay": wd,
                                "clips": clips, "dense_sq": dense_sq})
    workers.run("sparse_update", world, io, dcn=dcn, device="cpu")
    outs = [workers.load_outputs(io, r)[0] for r in range(world)]
    mesh = _jmesh(dcn, ici)

    for name in ("user", "item"):
        V = a[f"{name}_table"].shape[0]
        R, n = V // ici, a[f"{name}_ids"].shape[1]
        rep, tot = _jax_route_combine(
            mesh, a[f"{name}_ids"].reshape(-1),
            a[f"{name}_g"].reshape(-1, a[f"{name}_g"].shape[-1]), R, n, dcn,
            ici)
        m = rep.shape[0] // world
        for r in range(world):
            jr, jt = rep[r * m:(r + 1) * m], tot[r * m:(r + 1) * m]
            tr, tt = outs[r][f"{name}_rep"], outs[r][f"{name}_tot"]
            jv, tv = jr < R, tr < R
            np.testing.assert_array_equal(np.sort(tr[tv]), np.sort(jr[jv]))
            for row in jr[jv]:
                np.testing.assert_array_equal(
                    tt[tr == row][0].view(np.int32),
                    jt[jr == row][0].view(np.int32))

    for c, clip in enumerate(clips):
        jt, ja, jscale = jax.jit(
            lambda tabs, accs, ids, gs: jss.sharded_sparse_rowwise_adagrad_update(
                mesh, tabs, accs, ids, gs, lr, eps, wd, clip=clip,
                dense_sq=jnp.float32(dense_sq)))(
            [jnp.asarray(a["user_table"]), jnp.asarray(a["item_table"])],
            [jnp.asarray(a["user_acc"]), jnp.asarray(a["item_acc"])],
            [jnp.asarray(a["user_ids"].reshape(-1), jnp.int32),
             jnp.asarray(a["item_ids"].reshape(-1), jnp.int32)],
            [jnp.asarray(a["user_g"].reshape(-1, 8)),
             jnp.asarray(a["item_g"].reshape(-1, 8))])
        for r in range(world):
            assert abs(float(outs[r][f"c{c}_gscale"]) - float(jscale)) <= (
                1e-6 * float(jscale))
        for t, name in enumerate(("user", "item")):
            got_t = np.concatenate([outs[i][f"c{c}_{name}_table"]
                                    for i in range(ici)])
            got_a = np.concatenate([outs[i][f"c{c}_{name}_acc"]
                                    for i in range(ici)])
            np.testing.assert_allclose(got_t, np.asarray(jt[t]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got_a, np.asarray(ja[t]), rtol=1e-6,
                                       atol=1e-7)
            idle = np.setdiff1d(np.arange(got_t.shape[0]),
                                a[f"{name}_ids"].reshape(-1))
            np.testing.assert_array_equal(
                got_t[idle].view(np.int32),
                a[f"{name}_table"][idle].view(np.int32))
            for d in range(1, dcn):          # the replicas hold the same
                for i in range(ici):
                    np.testing.assert_array_equal(
                        outs[d * ici + i][f"c{c}_{name}_table"],
                        outs[i][f"c{c}_{name}_table"])
            if clip == 0:
                # the port's one-process update: the combine sums in the
                # same (global occurrence) order, so the bits are equal
                tab = torch.from_numpy(a[f"{name}_table"].copy())
                acc = torch.from_numpy(a[f"{name}_acc"].copy())
                tsparse.sparse_rowwise_adagrad_update(
                    tab, acc, torch.from_numpy(a[f"{name}_ids"].reshape(-1)),
                    torch.from_numpy(a[f"{name}_g"].reshape(-1, 8)),
                    torch.tensor(lr), eps, wd)
                np.testing.assert_array_equal(got_t.view(np.int32),
                                              tab.numpy().view(np.int32))
                np.testing.assert_array_equal(got_a.view(np.int32),
                                              acc.numpy().view(np.int32))
