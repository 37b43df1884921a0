"""The mesh training steps and the mesh tower on 2 and 4 gloo ranks
against the JAX package's mesh steps and the port's one process.

- The dense step (``make_train_step`` under a mesh): three steps at
  ``(1, 2)`` (the precompute branch, joint), ``(2, 2)`` (precompute off,
  independent, the reference through its explicit exchange) and ``(1, 4)``
  (the sequence path), f32 with dropout 0, every rank handed the global
  batch's negatives the reference's mesh step draws: params and Adam
  moments within 5e-5 of their largest magnitude per leaf
  (``tests/test_torch_train_step.py``'s tolerance) of the reference's and
  of the port's one-process step, the mean metrics within rtol 1e-5.
- The sparse step at ``(2, 2)`` with the sequence path and the clip on:
  tables, accumulators and dense params within ``tests/
  test_torch_sparse.py``'s step tolerance of the reference's mesh step
  and of the port's one-process sparse step.
- The tower's mesh form: each rank folds its rank into the dropout seed
  (masks differ between ranks, and equal the plain version's with the
  seed moved by the rank); without dropout the forward is the plain
  tower's on the rank's rows.
- ``sparse_mode_available`` under a mesh follows the reference's rule.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.ops import embedding as jemb  # noqa: E402
from ncf_tpu.parallel import (batch_sharding, param_shardings,  # noqa: E402
                              replicated, shard_pytree, state_shardings)
from ncf_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.train import step as jstep  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy  # noqa: E402
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.ops import embedding as temb  # noqa: E402
from ncf_tpu_torch.ops import tower as ttower  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

STEP_REL = 5e-5


def _cfgs(users, items, batch, sparse=False, **over):
    out = []
    for cfg in (JConfig(), Config()):
        m, t = cfg.model, cfg.train
        m.num_users, m.num_items = users, items
        m.mf_dim = m.mlp_dim = 8
        m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
        m.num_departments, m.num_categories = 3, 5
        m.negative_samples, m.fused_tower = 4, "off"
        m.compute_dtype, m.dropout = "float32", 0.0
        m.candidate_mode = over.get("mode", "joint")
        m.use_sequence = over.get("seq", False)
        m.history_len = 5
        t.batch_size, t.num_epochs = batch, 1
        t.weight_decay, t.gradient_clip_norm = 1e-3, over.get("clip", 0.05)
        t.embedding_scatter = "xla"
        if sparse:
            t.embedding_optimizer = "rowwise_adagrad"
            t.embedding_learning_rate = 0.01
            t.sparse_table_update = "on"
        cfg.mesh.embedding_exchange = over.get("exchange", "pjit")
        out.append(cfg)
    return out


def _meta(items, seed=0):
    rng = np.random.default_rng(seed)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    w = 1.0 / rng.zipf(1.3, items).astype(np.float64)
    return dept, cat, np.array(jsampler.make_sampling_cdf(w))


def _params(jcfg, seed=0):
    tree = jmodel.init(jax.random.PRNGKey(seed), jcfg.model)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(
            np.float32), tree)


def _batches(users, items, B, K, seed=0):
    inter = generate_interactions(num_users=users, num_items=items,
                                  num_days=30, avg_txns_per_user=6, seed=seed)
    it = BatchIterator(inter, B, seed=seed)
    out, epoch = [], 0
    while len(out) < K:
        out.extend(it.epoch(epoch))
        epoch += 1
    return inter, out[:K]


def _leaf_close(got, want, rel, what, floor=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = max(rel * np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(),
                                            tol)


def _flat(tree, prefix):
    """``{prefix.path: array}`` under the checkpoint's leaf names."""
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    return {f"{prefix}.{p}": (v.detach().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v))
            for p, v in _leaves_with_path(tree)}


def _jax_mesh_run(jcfg, np_params, batches, consts, hist, mesh, sparse):
    """The reference's mesh steps; also the negatives each drew."""
    mcfg, K = jcfg.model, len(batches)
    rep = replicated(mesh)
    dev = {k: jax.device_put(jnp.asarray(v), rep) for k, v in consts.items()}
    h = None if hist is None else jax.device_put(jnp.asarray(hist), rep)
    params = jax.tree.map(jnp.asarray, np_params)
    rows = {params[k].shape[0] for k in ("user_emb", "item_emb")}
    if sparse:
        dense_opt = joptim.make_optimizer(
            dataclasses.replace(jcfg.train, gradient_clip_norm=0.0), K)
        state = jstep.init_sparse_opt_state(dense_opt, params)
        step = jstep.make_sparse_train_step(
            jmodel, jcfg, dense_opt, joptim.make_schedule(jcfg.train, K),
            dev["cdf"], dev["dept"], dev["cat"], mesh=mesh, user_history=h)
    else:
        opt = joptim.make_optimizer(jcfg.train, K)
        state = opt.init(params)
        step = jstep.make_train_step(jmodel, jcfg, opt, dev["cdf"],
                                     dev["dept"], dev["cat"], h)
    params = shard_pytree(params, param_shardings(params, mesh, True))
    state = shard_pytree(state, state_shardings(state, mesh, True))
    if jcfg.mesh.embedding_exchange == "explicit":
        jemb.set_exchange(mesh, rows, 0.0)
    key = jax.device_put(jax.random.PRNGKey(5), rep)
    sample = (jsampler.sample_negatives_stratified
              if jcfg.train.negative_sampling == "stratified"
              else jsampler.sample_negatives)
    negs, metrics = [], []
    try:
        with mesh:
            for b in batches:
                _, step_rng = jax.random.split(jax.device_get(key))
                rng_neg, _ = jax.random.split(step_rng)
                negs.append(np.asarray(sample(
                    rng_neg, jnp.asarray(b["item_ids"]), mcfg.num_items,
                    mcfg.negative_samples, cdf=jnp.asarray(consts["cdf"]))))
                batch = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
                         for k, v in b.items()}
                params, state, key, m = step(params, state, key, batch)
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jemb.clear_exchange()
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            metrics, negs)


def _port_inputs(tcfg, np_params, batches, negs, consts, hist, mode):
    arrays = _flat(np_params, "params")
    for k, b in enumerate(batches):
        for c, v in b.items():
            arrays[f"batch{k}.{c}"] = v
        arrays[f"negs{k}"] = negs[k]
    arrays.update(consts)
    if hist is not None:
        arrays["user_history"] = hist
    meta = {"config": tcfg.to_dict(), "steps": len(batches), "mode": mode,
            "columns": sorted(batches[0]), "scatter": ["xla", "split"]}
    return arrays, meta


@pytest.mark.parametrize("dcn,ici,vocab,mode,exchange,seq", [
    (1, 2, True, "joint", "pjit", False),
    (2, 2, False, "independent", "explicit", False),
    (1, 4, True, "independent", "pjit", True),
])
def test_dense_mesh_step_matches_reference(tmp_path, dcn, ici, vocab, mode,
                                           exchange, seq):
    users, items, B = (100, 60, 64) if vocab else (400, 300, 16)
    K = 3
    jcfg, tcfg = _cfgs(users, items, B, mode=mode, exchange=exchange,
                       seq=seq)
    assert jmodel._use_vocab_precompute(jcfg.model, B * 5) == vocab
    dept, cat, cdf = _meta(items)
    consts = {"cdf": cdf, "dept": dept, "cat": cat}
    inter, batches = _batches(users, items, B, K)
    hist = inter.recent_history(5) if seq else None
    np_params = _params(jcfg)
    mesh = jmake_mesh(dcn=dcn, ici=ici, devices=jax.devices()[:dcn * ici])
    jparams, jstate, jmetrics, negs = _jax_mesh_run(
        jcfg, np_params, batches, consts, hist, mesh, sparse=False)

    io = str(tmp_path / "io")
    workers.save_inputs(io, *_port_inputs(tcfg, np_params, batches, negs,
                                          consts, hist, "dense"))
    workers.run("step", dcn * ici, io, dcn=dcn, device="cpu")
    out, meta = workers.load_outputs(io, 0)

    temb.set_scatter_impl("xla")
    try:
        params = params_from_numpy(np_params, "cpu")
        opt = toptim.make_optimizer(tcfg.train, K)
        state = opt.init(params)
        step = tstep.make_train_step(tmodel, tcfg, opt, cdf, dept, cat, hist,
                                     device="cpu")
        for b, n in zip(batches, negs):
            params, state, _, _ = step(params, state, torch.Generator(), b,
                                       n)
    finally:
        temb.set_scatter_impl("auto")
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    for (p, want), (_, one) in zip(
            _leaves_with_path(jax.tree.map(np.asarray, jparams)),
            _leaves_with_path(params)):
        _leaf_close(out[f"params.{p}"], want, STEP_REL, f"params.{p}")
        _leaf_close(out[f"params.{p}"], one.numpy(), STEP_REL, f"1:{p}")
    for mom in ("mu", "nu"):
        for (p, want), (_, one) in zip(
                _leaves_with_path(jax.tree.map(np.asarray,
                                               getattr(adam, mom))),
                _leaves_with_path(state[mom])):
            _leaf_close(out[f"{mom}.{p}"], want, STEP_REL, f"{mom}.{p}")
            _leaf_close(out[f"{mom}.{p}"], one.numpy(), STEP_REL,
                        f"1:{mom}.{p}")
    for got, want in zip(meta["metrics"], jmetrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("accuracy", "pos_accuracy", "neg_accuracy"):
            assert abs(got[k] - want[k]) <= 1.0 / B


def test_sparse_mesh_step_matches_reference(tmp_path):
    dcn, ici = 2, 2
    users, items, B, K = 900, 600, 64, 3
    jcfg, tcfg = _cfgs(users, items, B, sparse=True, seq=True, clip=0.05)
    assert jstep.sparse_mode_available(jcfg)
    dept, cat, cdf = _meta(items)
    consts = {"cdf": cdf, "dept": dept, "cat": cat}
    inter, batches = _batches(users, items, B, K)
    hist = inter.recent_history(5)
    np_params = _params(jcfg)
    mesh = jmake_mesh(dcn=dcn, ici=ici, devices=jax.devices()[:dcn * ici])
    assert jstep.sparse_mode_available(jcfg, mesh)
    jparams, jstate, _, negs = _jax_mesh_run(
        jcfg, np_params, batches, consts, hist, mesh, sparse=True)
    io = str(tmp_path / "io")
    workers.save_inputs(io, *_port_inputs(tcfg, np_params, batches, negs,
                                          consts, hist, "sparse"))
    workers.run("step", dcn * ici, io, dcn=dcn, device="cpu")
    out, _ = workers.load_outputs(io, 0)

    params = params_from_numpy(np_params, "cpu")
    dense_opt = toptim.make_optimizer(dataclasses.replace(
        tcfg.train, gradient_clip_norm=0.0), K)
    state = tstep.init_sparse_opt_state(dense_opt, params)
    step = tstep.make_sparse_train_step(
        tmodel, tcfg, dense_opt, toptim.make_schedule(tcfg.train, K), cdf,
        dept, cat, user_history=hist, device="cpu")
    for b, n in zip(batches, negs):
        params, state, _, _ = step(params, state, torch.Generator(), b, n)
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    for (p, want), (_, one) in zip(
            _leaves_with_path(jax.tree.map(np.asarray, jparams)),
            _leaves_with_path(params)):
        _leaf_close(out[f"params.{p}"], want, STEP_REL, f"params.{p}")
        _leaf_close(out[f"params.{p}"], one.numpy(), STEP_REL, f"1:{p}")
    for k in ("user_acc", "item_acc"):
        _leaf_close(out[k], np.asarray(jstate[k]), STEP_REL, k)
        _leaf_close(out[k], state[k].numpy(), STEP_REL, f"1:{k}")


def test_mesh_tower_folds_the_rank_into_the_seed():
    gen = torch.Generator().manual_seed(0)
    layers = [{"dense": {"w": torch.randn(12, 16, generator=gen),
                         "b": torch.randn(16, generator=gen)},
               "norm": {"scale": torch.ones(16), "bias": torch.zeros(16)}},
              {"dense": {"w": torch.randn(16, 8, generator=gen),
                         "b": torch.randn(8, generator=gen)},
               "norm": {"scale": torch.ones(8), "bias": torch.zeros(8)}}]
    x = torch.randn(32, 12, generator=gen)
    outs = []
    for rank in range(4):
        mesh = types.SimpleNamespace(rank=rank)
        rng = torch.Generator().manual_seed(7)
        y = ttower.fused_tower(layers, x, 0.3, rng, False, mesh=mesh)
        outs.append(y)
        # the same draw, moved by the rank, through the plain version
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(7)))
        mask0 = ttower.dropout_bits(torch.tensor([seed + rank]), 0, 32, 16)
        assert np.array_equal((mask0 < ttower.keep_threshold(0.3)).numpy(),
                              _pre_dropout_kept(layers, x, seed + rank))
    for a in outs[1:]:
        assert not torch.equal(a, outs[0])         # distinct masks a rank
    det = [ttower.fused_tower(layers, x, 0.3, None, True,
                              mesh=types.SimpleNamespace(rank=r))
           for r in range(2)]
    assert torch.equal(det[0], det[1])
    assert torch.equal(det[0], ttower.fused_tower_ref(layers, x, 0.3, None,
                                                      True))


def _pre_dropout_kept(layers, x, seed):
    """Which first-layer activations the plain tower keeps for ``seed``
    (zeros of the output of layer 0 under dropout)."""
    flat = [layers[0]["dense"]["w"], layers[0]["dense"]["b"],
            layers[0]["norm"]["scale"], layers[0]["norm"]["bias"]]
    h = x.to(torch.bfloat16).to(torch.float32)
    _, _, _, _, mask = ttower._layer_fwd(h, *[p.float() for p in flat], 0,
                                         torch.tensor([seed]), 0.3)
    return mask.numpy()


def test_sparse_mode_gate_follows_the_reference_rule():
    mesh = types.SimpleNamespace(shape={"dcn": 2, "ici": 2})
    for users, items, batch in ((900, 600, 64), (901, 600, 64),
                                (900, 601, 64), (900, 600, 66)):
        jcfg, tcfg = _cfgs(users, items, batch, sparse=True)
        jmesh = jmake_mesh(dcn=2, ici=2, devices=jax.devices()[:4])
        assert (tstep.sparse_mode_available(tcfg, mesh)
                == jstep.sparse_mode_available(jcfg, jmesh))
