"""Port parity for the sparse table update (``train/sparse.py``, the
sparse builders of ``train/step.py``, row injection in
``models/advanced_ncf.py::apply``, the ``Trainer``'s sparse branch and its
checkpoints) against ``ncf_tpu``, on the CPU at a small size: the
precompute-off config of ``tests/test_sparse_update.py`` (900 users x 600
items, 8-wide tables, tower [16, 8], batch 64, f32, rowwise Adagrad with
a table learning rate of 0.01).

Tolerances, each stated where it is used:

- ``combine_duplicate_rows``: ids equal; totals equal bit for bit (both
  add each segment's rows in f32 in their order of occurrence).
- ``sparse_rowwise_adagrad_apply``/``_update``: tables and accumulators
  within rtol 1e-6, atol 1e-7 (one rowwise step in f32); rows no id
  touches equal bit for bit, signed zeros included.
- ``apply`` with injected rows: logits within rtol 1e-5, atol 1e-6, row and
  dense gradients within 1e-5 of each leaf's largest magnitude (f32 sums
  in another order; dense leaves with a floor of 1e-7 of the largest
  dense gradient, for leaves that are zero in exact arithmetic).
- Three sparse steps against the reference's: params, accumulators and
  the dense Adam state within 5e-5 of each leaf's largest magnitude (as
  ``test_torch_train_step.py``'s three dense steps), counts exact.
- The port's sparse ``Trainer`` against its dense rowwise ``Trainer`` (the
  properties of ``tests/test_sparse_update.py``): params within rtol
  2e-4, atol 2e-5, accumulators within rtol 1e-4, atol 1e-6, the
  reference's own tolerances for the same comparison.
- Checkpoints across packages: every leaf equal bit for bit; a resumed
  run ends in the same bits as an uninterrupted one.
"""

import dataclasses
import itertools
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgenerate  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.train import Trainer as JTrainer  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.train import sparse as jsparse  # noqa: E402
from ncf_tpu.train import step as jstep  # noqa: E402
from ncf_tpu.train.checkpoint import _path_str  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (params_from_numpy,  # noqa: E402
                                   tree_leaves)
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.train import Trainer  # noqa: E402
from ncf_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import sparse as tsparse  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

LOG = dict(num_users=900, num_items=600, num_days=40, avg_txns_per_user=6,
           seed=11)
STEP_REL = 5e-5
TRAINER_RTOL, TRAINER_ATOL = 2e-4, 2e-5
ACC_RTOL, ACC_ATOL = 1e-4, 1e-6


def _big(cfg, sparse="auto", **train):
    """The precompute-off config: entities (1500) > 4*B*S (1280)."""
    m, t = cfg.model, cfg.train
    m.num_users, m.num_items = 900, 600
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims = 4, [16, 8]
    m.compute_dtype = "float32"
    t.batch_size, t.num_epochs = 64, 2
    t.embedding_optimizer = "rowwise_adagrad"
    t.embedding_learning_rate = 0.01
    t.embedding_scatter = "xla"
    t.sparse_table_update = sparse
    for k, v in train.items():
        section = cfg.model if k in ("use_sequence", "history_len",
                                     "dropout", "candidate_mode") else t
        setattr(section, k, v)
    return cfg


@pytest.fixture(scope="module")
def logs():
    return generate_interactions(**LOG), jgenerate(**LOG)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _rel_close(got, want, rel, what, floor=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = max(rel * np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(),
                                            tol)


# ------------------------------------------------------------ the combine

@pytest.mark.parametrize("case", ["duplicates", "all_equal", "distinct",
                                  "many"])
def test_combine_duplicate_rows_matches(case):
    rng = np.random.default_rng(len(case))
    n, d, V = {"duplicates": (6, 2, 10), "all_equal": (9, 3, 10),
               "distinct": (7, 4, 50), "many": (300, 8, 40)}[case]
    if case == "duplicates":
        ids = np.array([7, 2, 7, 5, 2, 2], np.int32)
    elif case == "all_equal":
        ids = np.full(n, 4, np.int32)
    elif case == "distinct":
        ids = rng.permutation(V)[:n].astype(np.int32)
    else:
        ids = rng.integers(0, V, n).astype(np.int32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    jrep, jtot = jsparse.combine_duplicate_rows(jnp.asarray(ids),
                                                jnp.asarray(g), V)
    rep, tot = tsparse.combine_duplicate_rows(torch.from_numpy(ids),
                                              torch.from_numpy(g), V)
    np.testing.assert_array_equal(_np(rep), np.asarray(jrep))
    np.testing.assert_array_equal(_np(tot), np.asarray(jtot))
    rep = _np(rep)
    assert len(set(rep.tolist())) == n                  # sinks distinct
    k = len(np.unique(ids))
    assert (rep[k:] >= V).all() and (rep[:k] < V).all()
    assert not _np(tot)[k:].any()


@pytest.mark.parametrize("wd", [0.0, 1e-5, 0.1])
def test_sparse_rowwise_adagrad_matches(wd):
    rng = np.random.default_rng(int(wd * 1e6) + 1)
    V, d, N = 50, 8, 32
    table = rng.normal(size=(V, d)).astype(np.float32)
    table[45] = 0.0                                     # signed zeros kept
    table[46] = -0.0
    acc = rng.random(V).astype(np.float32)
    ids = rng.integers(0, 40, N).astype(np.int32)
    g = rng.normal(size=(N, d)).astype(np.float32)
    lr, eps = 0.05, 1e-8
    jt, ja = jsparse.sparse_rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(g), lr, eps, wd)
    tt, ta = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    out = tsparse.sparse_rowwise_adagrad_update(
        tt, ta, torch.from_numpy(ids), torch.from_numpy(g),
        torch.tensor(lr), eps, wd)
    assert out[0] is tt and out[1] is ta                # in place
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-6, atol=1e-7)
    idle = np.setdiff1d(np.arange(V), ids)
    # the sinks land on rows 0..N-1-k with -0.0: untouched rows keep bits
    np.testing.assert_array_equal(_np(tt)[idle].view(np.int32),
                                  table[idle].view(np.int32))
    np.testing.assert_array_equal(_np(ta)[idle].view(np.int32),
                                  acc[idle].view(np.int32))


def test_sinks_wrap_past_a_small_table():
    """More slots than rows: the sinks ``V + k`` wrap to ``k mod V``."""
    rng = np.random.default_rng(5)
    V, d, N = 6, 4, 40
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = np.array([1, 3] * (N // 2), np.int32)
    g = rng.normal(size=(N, d)).astype(np.float32)
    acc = np.zeros(V, np.float32)
    jt, ja = jsparse.sparse_rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(g), 0.1)
    tt, ta = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    tsparse.sparse_rowwise_adagrad_update(tt, ta, torch.from_numpy(ids),
                                          torch.from_numpy(g), 0.1)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-6, atol=1e-7)
    for r in (0, 2, 4, 5):
        np.testing.assert_array_equal(_np(tt)[r], table[r])


# ------------------------------------------------------------ row injection

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


def _cfg_pair(**kw):
    jcfg, tcfg = _big(JConfig(), **kw), _big(Config(), **kw)
    for cfg in (jcfg, tcfg):
        cfg.model.num_departments, cfg.model.num_categories = 3, 5
        cfg.model.dropout, cfg.model.fused_tower = 0.0, "off"
    return jcfg, tcfg


@pytest.mark.parametrize("mode", ["joint", "independent"])
@pytest.mark.parametrize("with_history", [False, True])
def test_apply_with_injected_rows_matches(mode, with_history):
    jcfg, tcfg = _cfg_pair(use_sequence=with_history, history_len=5,
                           candidate_mode=mode)
    B, S, H = 64, 5, 5
    assert not jmodel._use_vocab_precompute(jcfg.model, B * S)
    dept, cat, _ = _meta(600)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 900, B).astype(np.int32)
    it = rng.integers(0, 600, (B, S)).astype(np.int32)
    hist = rng.integers(-1, 600, (B, H)).astype(np.int32)
    temporal = {"hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
                "month": rng.integers(0, 12, B),
                "day_of_year": rng.integers(0, 400, B)}
    temporal = {k: v.astype(np.int32) for k, v in temporal.items()}
    np_params = _params(jcfg)
    hsafe = np.maximum(hist, 0)
    rows = [np_params["user_emb"][u], np_params["item_emb"][it]]
    if with_history:
        rows.append(np_params["item_emb"][hsafe])
    dense = {k: v for k, v in np_params.items()
             if k not in ("user_emb", "item_emb")}
    tables = {k: np_params[k] for k in ("user_emb", "item_emb")}

    def jloss(dense_p, rows_p):
        logits = jmodel.apply(
            {**dense_p, **tables}, jcfg.model, jnp.asarray(u),
            jnp.asarray(it), {k: jnp.asarray(v) for k, v in temporal.items()},
            jnp.asarray(dept), jnp.asarray(cat),
            candidate_attention=mode == "joint",
            history=jnp.asarray(hist) if with_history else None,
            user_rows=rows_p[0], item_rows=rows_p[1],
            history_rows=rows_p[2] if with_history else None)
        return logits.sum() * 0.01 + (logits ** 2).mean(), logits

    (jval, jlogits), (jgd, jgr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, dense), [jnp.asarray(r) for r in rows])

    tdense = params_from_numpy(dense, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tdense)]
    trows = [torch.from_numpy(r.copy()).requires_grad_(True) for r in rows]
    logits = tmodel.apply(
        {**tdense, **params_from_numpy(tables, "cpu")}, tcfg.model,
        torch.from_numpy(u), torch.from_numpy(it),
        {k: torch.from_numpy(v) for k, v in temporal.items()},
        torch.from_numpy(dept), torch.from_numpy(cat),
        candidate_attention=mode == "joint",
        history=torch.from_numpy(hist) if with_history else None,
        user_rows=trows[0], item_rows=trows[1],
        history_rows=trows[2] if with_history else None)
    loss = logits.sum() * 0.01 + (logits ** 2).mean()
    grads = torch.autograd.grad(loss, leaves + trows, allow_unused=True)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-6)
    for i, (got, want) in enumerate(zip(grads[len(leaves):], jgr)):
        _rel_close(_np(got), np.asarray(want), 1e-5, f"rows {i}")
    # leaves that are zero in exact arithmetic (the attention key bias
    # under the softmax) are rounding noise in both: a floor of 1e-7 of
    # the largest dense gradient
    floor = 1e-7 * max(np.abs(np.asarray(w)).max()
                       for w in jax.tree.leaves(jgd))
    for got, want in zip(grads[:len(leaves)], jax.tree.leaves(jgd)):
        got = np.zeros(want.shape) if got is None else _np(got)
        _rel_close(got, np.asarray(want), 1e-5, "dense", floor)
    if with_history:                       # padded slots: exactly zero
        assert not _np(grads[-1])[hist < 0].any()


def test_injection_is_refused_under_the_precompute():
    _, tcfg = _cfg_pair()
    tcfg.model.num_users, tcfg.model.num_items = 20, 10
    params = tmodel.init(torch.Generator().manual_seed(0), tcfg.model,
                         device="cpu")
    u = torch.zeros(4, dtype=torch.int32)
    it = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(AssertionError, match="precompute-OFF"):
        tmodel.apply(params, tcfg.model, u, it,
                     user_rows=params["user_emb"][u.long()])


# -------------------------------------------------------- three sparse steps

def _batches(K, B=64, seed=0):
    inter = generate_interactions(**LOG)
    it = BatchIterator(inter, B, seed=seed)
    out, epoch = [], 0
    while len(out) < K:
        out.extend(it.epoch(epoch))
        epoch += 1
    return inter, out[:K]


def _jax_sparse_run(jcfg, np_params, batches, dept, cat, cdf, hist, seed):
    mcfg, K = jcfg.model, len(batches)
    dense_opt = joptim.make_optimizer(
        dataclasses.replace(jcfg.train, gradient_clip_norm=0.0), K)
    schedule = joptim.make_schedule(jcfg.train, K)
    params = jax.tree.map(jnp.asarray, np_params)
    state = jstep.init_sparse_opt_state(dense_opt, params)
    step = jstep.make_sparse_train_step(
        jmodel, jcfg, dense_opt, schedule, jnp.asarray(cdf),
        jnp.asarray(dept), jnp.asarray(cat),
        user_history=None if hist is None else jnp.asarray(hist))
    key = jax.random.PRNGKey(seed)
    negs = []
    for b in batches:
        _, step_rng = jax.random.split(key)                 # step.py:302
        rng_neg, _ = jax.random.split(step_rng)             # step.py:305
        negs.append(np.asarray(jsampler.sample_negatives(
            rng_neg, jnp.asarray(b["item_ids"]), mcfg.num_items,
            mcfg.negative_samples, cdf=jnp.asarray(cdf))))
        params, state, key, _ = step(params, state, key,
                                     {k: jnp.asarray(v) for k, v in b.items()})
    return params, state, negs


@pytest.mark.parametrize("clip,seq,ewd", [(5.0, False, 0.0), (0.05, False, 0.0),
                                          (0.05, True, 1e-3), (0.0, True, 0.0)])
def test_three_sparse_steps_match(clip, seq, ewd):
    jcfg, tcfg = _cfg_pair(gradient_clip_norm=clip, use_sequence=seq,
                           history_len=5, embedding_weight_decay=ewd,
                           weight_decay=1e-3)
    K = 3
    dept, cat, cdf = _meta(600)
    inter, batches = _batches(K)
    hist = inter.recent_history(5) if seq else None
    np_params = _params(jcfg)
    jparams, jstate, negs = _jax_sparse_run(jcfg, np_params, batches, dept,
                                            cat, cdf, hist, seed=5)
    params = params_from_numpy(np_params, "cpu")
    dense_opt = toptim.make_optimizer(
        dataclasses.replace(tcfg.train, gradient_clip_norm=0.0), K)
    state = tstep.init_sparse_opt_state(dense_opt, params)
    multi = tstep.make_sparse_multi_train_step(
        tmodel, tcfg, dense_opt, toptim.make_schedule(tcfg.train, K), cdf,
        dept, cat, user_history=hist, device="cpu")
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    params, state, _, metrics = multi(params, state, torch.Generator(),
                                      stacked, np.stack(negs))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jparams),
                                 tree_leaves(params)):
        _rel_close(_np(got), np.asarray(want), STEP_REL, _path_str(path))
    for k in ("user_acc", "item_acc"):
        _rel_close(_np(state[k]), np.asarray(jstate[k]), STEP_REL, k)
    assert int(state["count"]) == int(jstate["count"]) == K
    named = dict(ckpt._leaves_with_path(ckpt.named_opt_state(
        state, clip, 1e-3, ewd, 0.01)))
    jnamed = {_path_str(p): v
              for p, v in jax.tree_util.tree_leaves_with_path(jstate)}
    assert set(named) == set(jnamed)
    for k, want in jnamed.items():
        if np.asarray(want).dtype == np.int32:
            assert int(named[k]) == int(want), k
        else:
            _rel_close(_np(named[k]), np.asarray(want), STEP_REL, k)
    assert np.isfinite(float(metrics["loss"]))


def test_sparse_step_keeps_the_tables_out_of_autograd(monkeypatch):
    """The tables are no leaves of the step's autograd (no [V, d]
    gradient, no [V, d] zeros), and only touched rows change."""
    _, tcfg = _cfg_pair()
    dept, cat, cdf = _meta(600)
    _, (batch,) = _batches(1)
    params = tmodel.init(torch.Generator().manual_seed(0), tcfg.model,
                         device="cpu")
    before = {k: params[k].clone() for k in ("user_emb", "item_emb")}
    dense_opt = toptim.make_optimizer(tcfg.train)
    state = tstep.init_sparse_opt_state(dense_opt, params)
    seen = []
    real = torch.autograd.grad

    def spy(outputs, inputs, *a, **kw):
        seen.extend(inputs)
        return real(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    step = tstep.make_sparse_train_step(
        tmodel, tcfg, dense_opt, toptim.make_schedule(tcfg.train, 1), cdf,
        dept, cat, device="cpu")
    negs = np.random.default_rng(0).integers(0, 600, (64, 4))
    step(params, state, torch.Generator(), batch, negs)
    shapes = {tuple(t.shape) for t in seen}
    assert (900, 16) not in shapes and (600, 16) not in shapes
    items = np.concatenate([batch["item_ids"][:, None], negs], 1)
    for k, ids in (("user_emb", batch["user_ids"]), ("item_emb", items)):
        idle = np.setdiff1d(np.arange(before[k].shape[0]), ids)
        assert torch.equal(params[k][idle], before[k][idle])
        assert not torch.equal(params[k], before[k])


def test_sparse_mode_gating_matches():
    for kw, model in ((dict(), {}),
                      (dict(), {"num_users": 100, "num_items": 50}),
                      (dict(embedding_optimizer="adam"), {}),
                      (dict(use_sequence=True), {}),
                      (dict(use_sequence=True), {"causal_history": True})):
        jcfg, tcfg = _cfg_pair(**kw)
        for k, v in model.items():
            setattr(jcfg.model, k, v)
            setattr(tcfg.model, k, v)
        assert (tstep.sparse_mode_available(tcfg)
                == jstep.sparse_mode_available(jcfg))
    # under a mesh, the reference's divisibility rule
    import types

    from ncf_tpu.parallel.mesh import make_mesh as jmake_mesh

    for (dcn, ici), (users, batch) in itertools.product(
            ((1, 2), (2, 2), (1, 4)), ((900, 64), (902, 64), (900, 66))):
        jcfg, tcfg = _cfg_pair()
        for cfg in (jcfg, tcfg):
            cfg.model.num_users, cfg.train.batch_size = users, batch
        jmesh = jmake_mesh(dcn=dcn, ici=ici,
                           devices=jax.devices()[:dcn * ici])
        tmesh = types.SimpleNamespace(shape={"dcn": dcn, "ici": ici})
        assert (tstep.sparse_mode_available(tcfg, tmesh)
                == jstep.sparse_mode_available(jcfg, jmesh))


# ------------------------------------- the Trainer: sparse against dense

def _trainer_pair(tmp_path, tinter, tag, **kw):
    a = Trainer(_big(Config(), "off", checkpoint_dir=str(tmp_path / f"a{tag}"),
                     **kw), tinter, device="cpu")
    b = Trainer(_big(Config(), "on", checkpoint_dir=str(tmp_path / f"b{tag}"),
                     **kw), tinter, device="cpu")
    assert not a.sparse_tables and b.sparse_tables
    return a, b


def _assert_trainers_agree(a, b, what):
    for (path, x), y in zip(ckpt._leaves_with_path(a.params),
                            tree_leaves(b.params)):
        np.testing.assert_allclose(_np(y), _np(x), rtol=TRAINER_RTOL,
                                   atol=TRAINER_ATOL,
                                   err_msg=f"{what} {path}")
    sum_sq = a.opt_state["embedding"]["sum_sq"]
    for table, acc in (("user_emb", "user_acc"), ("item_emb", "item_acc")):
        np.testing.assert_allclose(_np(b.opt_state[acc]),
                                   _np(sum_sq[table]), rtol=ACC_RTOL,
                                   atol=ACC_ATOL, err_msg=f"{what} {acc}")


@pytest.mark.parametrize("spd", [1, 3])
def test_sparse_trainer_matches_dense_rowwise(tmp_path, logs, spd):
    a, b = _trainer_pair(tmp_path, logs[0], spd, steps_per_dispatch=spd)
    a.train()
    b.train()
    _assert_trainers_agree(a, b, f"spd {spd}")


def test_sparse_trainer_clip_trigger(tmp_path, logs):
    a, b = _trainer_pair(tmp_path, logs[0], "clip", gradient_clip_norm=0.05,
                         num_epochs=1)
    a.train_epoch(0)
    b.train_epoch(0)
    _assert_trainers_agree(a, b, "clip")


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_sparse_trainer_sequence_matches_dense(tmp_path, logs, clip):
    a, b = _trainer_pair(tmp_path, logs[0], f"seq{clip}",
                         gradient_clip_norm=clip, use_sequence=True,
                         history_len=5, num_epochs=1)
    a.train_epoch(0)
    b.train_epoch(0)
    if clip == 0.0:
        va, vb = a.validate(0), b.validate(0)
        assert np.isclose(va["val_loss"], vb["val_loss"], rtol=1e-4)
        assert np.isfinite(va["hr@10"])
    _assert_trainers_agree(a, b, f"sequence clip {clip}")


def test_sparse_trainer_defaults_dispatch_to_eight(tmp_path, logs):
    cfg = _big(Config(), steps_per_dispatch=0,
               checkpoint_dir=str(tmp_path))
    t = Trainer(cfg, logs[0], device="cpu")
    assert t.sparse_tables and cfg.train.steps_per_dispatch == 8


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "partial_rowwise_adam",
                                  "bf16_adam", "adam"])
def test_table_optimizers_train_through_the_dense_path(tmp_path, logs, kind):
    cfg = _big(Config(), "off", embedding_optimizer=kind, num_epochs=1,
               embedding_weight_decay=1e-5, checkpoint_dir=str(tmp_path))
    t = Trainer(cfg, logs[0], device="cpu")
    assert not t.sparse_tables
    assert isinstance(t.optimizer, toptim.TableOptimizer)
    before = t.params["user_emb"].clone()
    m = t.train_epoch(0)
    assert np.isfinite(m["loss"]) and not torch.equal(before,
                                                      t.params["user_emb"])


# ------------------------------------------- checkpoints across packages

def _fill(jt, steps=7):
    """A JAX ``Trainer`` in the state of one that took ``steps`` steps:
    perturbed params, non-zero state, the counts at ``steps``."""
    rng = np.random.default_rng(steps)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(steps, np.int32).reshape(x.shape)
        return (np.abs(rng.normal(size=x.shape)) * 1e-3).astype(x.dtype)

    jt.params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
                   ).astype(np.asarray(x).dtype), jt.params)
    jt.opt_state = jax.tree.map(fill, jt.opt_state)
    jt.global_step = steps


def _named_np(tree):
    return {p: _np(v).astype(np.float32) if str(_np(v).dtype) == "bfloat16"
            else _np(v) for p, v in ckpt._leaves_with_path(tree)}


def _jnamed(tree):
    return {_path_str(p): np.asarray(v).astype(np.float32)
            if str(np.asarray(v).dtype) == "bfloat16" else np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


CKPT_CASES = {
    "sparse": dict(sparse="on", weight_decay=1e-5,
                   embedding_weight_decay=1e-5),
    "rowwise_dense": dict(sparse="off", gradient_clip_norm=5.0,
                          embedding_weight_decay=1e-5),
    "bf16_dense": dict(sparse="off", embedding_optimizer="bf16_adam",
                       embedding_learning_rate=0.0),
    "partial_dense": dict(sparse="off",
                          embedding_optimizer="partial_rowwise_adam",
                          gradient_clip_norm=0.0, weight_decay=0.0),
}


def _ckpt_cfgs(tmp_path, case):
    kw = dict(CKPT_CASES[case])
    sparse = kw.pop("sparse")
    return tuple(_big(c, sparse, checkpoint_dir=str(tmp_path), num_epochs=1,
                      **kw) for c in (JConfig(), Config()))


def _assert_states_equal(tt, jt, what):
    port = _named_np({"params": tt.params, "opt_state": tt._named_opt_state()})
    ref = _jnamed({"params": jt.params, "opt_state": jt.opt_state})
    assert port.keys() == ref.keys(), what
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, logs, caplog, case):
    tinter, jinter = logs
    jcfg, tcfg = _ckpt_cfgs(tmp_path, case)
    jt = JTrainer(jcfg, jinter)
    _fill(jt)
    path = jt.save_checkpoint(0, {"val_loss": 1.0})
    tt = Trainer(tcfg, tinter, device="cpu")
    assert tt.sparse_tables == jt.sparse_tables
    with caplog.at_level(logging.WARNING, logger="ncf_tpu_torch"):
        assert tt.resume(path)
    assert "no rng key" in caplog.text
    _assert_states_equal(tt, jt, case)
    assert tt.global_step == jt.global_step and tt.start_epoch == 1
    tt.train_epoch(0)                                   # and trains on


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_port_checkpoint_resumes_in_jax(tmp_path, logs, caplog, case):
    tinter, jinter = logs
    jcfg, tcfg = _ckpt_cfgs(tmp_path, case)
    tt = Trainer(tcfg, tinter, device="cpu")
    tt.train_epoch(0)
    path = tt.save_checkpoint(0, {"val_loss": 1.0})
    jt = JTrainer(jcfg, jinter)
    with caplog.at_level(logging.WARNING, logger="ncf_tpu"):
        assert jt.resume(path)
    assert "no rng key" in caplog.text
    _assert_states_equal(tt, jt, case)
    assert jt.global_step == tt.global_step > 0


def test_sparse_mid_epoch_resume_is_bit_exact(tmp_path, logs):
    kw = dict(checkpoint_every_dispatches=3, keep_checkpoints=100,
              steps_per_dispatch=2, checkpoint_dir=str(tmp_path / "ck"))
    t_a = Trainer(_big(Config(), "on", **kw), logs[0], device="cpu")
    t_a.train()
    mids = []
    for name in sorted(os.listdir(tmp_path / "ck")):
        mf = tmp_path / "ck" / name / "manifest.json"
        if mf.is_file():
            m = json.loads(mf.read_text())
            if (m.get("extra") or {}).get("in_epoch") and m["epoch"] > 0:
                mids.append(str(tmp_path / "ck" / name))
    assert mids
    t_b = Trainer(_big(Config(), "on", **kw), logs[0], device="cpu")
    assert t_b.resume(mids[0])
    t_b.train()
    assert t_b.global_step == t_a.global_step
    for (p, x), (_, y) in zip(
            ckpt._leaves_with_path({"p": t_a.params,
                                    "o": t_a._named_opt_state()}),
            ckpt._leaves_with_path({"p": t_b.params,
                                    "o": t_b._named_opt_state()})):
        assert torch.equal(x, y), p
    assert torch.equal(t_a.rng.get_state(), t_b.rng.get_state())
