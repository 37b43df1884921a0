"""Port parity for the sequence path (``use_sequence``) against
``ncf_tpu`` at a small size (8-wide tables, tower [16, 8], 2 heads,
history 6): ``apply`` with history, its loss and gradients, whole
training steps with a per-user history table and with causal per-example
histories in the batch, the eval step, ``score_items_with_hour``,
``SequenceRescoreScorer`` and ``ModelServer(user_history=...)``, the
history tables and the conversion of a sequence model's params and Adam
state.

Tolerances, all in float32 compute, where the packages differ only in the
order of f32 sums: logits atol 1e-5; loss rtol 1e-5 and every gradient
leaf within 1e-5 of its largest magnitude (floor 1e-7 of the tree's
largest, for leaves that are zero in exact arithmetic); three steps:
params and Adam moments within 5e-5 of their largest magnitude per leaf
(Adam divides by sqrt(v)), accuracies within one decision; served ids
equal and probabilities within 1e-5.  bf16 logits: atol 2e-2 (an ulp
before a bf16 rounding moves a result by up to 2^-8).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.data.interactions import Interactions as JInteractions  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgenerate  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.serving import ModelServer as JServer  # noqa: E402
from ncf_tpu.serving.scorer import SequenceRescoreScorer as JSeqScorer  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.train import step as jstep  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                   adam_state_to_numpy, params_from_numpy,
                                   params_to_numpy, tree_leaves)
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.serving import ModelServer  # noqa: E402
from ncf_tpu_torch.serving.scorer import SequenceRescoreScorer  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

H = 6
VOCAB = {True: (100, 60, 64), False: (400, 300, 16)}   # users, items, batch


def _cfgs(users, items, batch, dtype="float32", mode="joint", **over):
    out = []
    for cfg in (JConfig(), Config()):
        m, t = cfg.model, cfg.train
        m.num_users, m.num_items = users, items
        m.mf_dim = m.mlp_dim = 8
        m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
        m.num_departments, m.num_categories = 3, 5
        m.negative_samples, m.fused_tower = 4, "off"
        m.use_sequence, m.history_len = True, H
        m.compute_dtype, m.dropout, m.candidate_mode = dtype, 0.0, mode
        t.batch_size, t.num_epochs = batch, 1
        t.lr_schedule, t.weight_decay = "constant", 1e-3
        t.gradient_clip_norm = over.get("clip", 5.0)
        t.negative_sampling = over.get("sampling", "iid")
        t.loss = over.get("loss", "bce")
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


def _history(rows, items, seed):
    """Histories with every kind of row: full, partly padded (-1 at the
    end, as ``recent_history`` pads) and all padding."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, items, (rows, H)).astype(np.int32)
    n = rng.integers(0, H + 1, rows)
    n[:3] = (0, H, 2)
    hist[np.arange(H)[None, :] >= n[:, None]] = -1
    return hist


def _assert_tree_close(got, want, rel, what):
    g = [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                    np.float64) for a in tree_leaves(got)]
    w = [np.asarray(b, np.float64) for b in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    floor = 1e-7 * max(np.abs(b).max() for b in w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, what
        tol = max(rel * np.abs(b).max(), floor)
        assert np.abs(a - b).max() <= tol, (what, i, np.abs(a - b).max(),
                                            tol)


def _inputs(users, items, B, seed=1):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, B).astype(np.int32)
    it = rng.integers(0, items, (B, 5)).astype(np.int32)
    temporal = {"hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
                "month": rng.integers(0, 12, B),
                "day_of_year": rng.integers(0, 400, B)}
    return u, it, {k: v.astype(np.int32) for k, v in temporal.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ----------------------------------------------------------------- model

def test_init_has_the_sequence_block():
    jcfg, tcfg = _cfgs(*VOCAB[True])
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jmodel.init(jax.random.PRNGKey(0), jcfg.model))
    got = jax.tree.map(lambda a: tuple(a.shape),
                       tmodel.init(torch.Generator(), tcfg.model))
    assert got == want
    assert got["mlp"][0]["dense"]["w"] == (8 + 8 + 4, 16)
    assert set(got["sequence_attn"]) == {"q", "k", "v", "o"}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("candidate_attention", (True, False))
@pytest.mark.parametrize("vocab", (True, False))
def test_apply_with_history_matches(vocab, candidate_attention, dtype):
    users, items, B = VOCAB[vocab]
    jcfg, tcfg = _cfgs(users, items, B, dtype=dtype)
    assert jmodel._use_vocab_precompute(jcfg.model, B * 5) == vocab
    dept, cat, _ = _meta(items)
    u, it, temporal = _inputs(users, items, B)
    hist = _history(B, items, 2)
    np_params = _params(jcfg)
    for h in (hist, None):
        want = jax.jit(lambda p, *a: jmodel.apply(
            p, jcfg.model, *a, candidate_attention=candidate_attention,
            history=None if h is None else jnp.asarray(h)))(
            _j(np_params), jnp.asarray(u), jnp.asarray(it), _j(temporal),
            jnp.asarray(dept), jnp.asarray(cat))
        got = tmodel.apply(
            params_from_numpy(np_params, "cpu"), tcfg.model,
            torch.from_numpy(u), torch.from_numpy(it), _t(temporal),
            torch.from_numpy(dept), torch.from_numpy(cat),
            candidate_attention=candidate_attention,
            history=None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            rtol=0, atol={"float32": 1e-5, "bfloat16": 2e-2}[dtype])


@pytest.mark.parametrize("mode", ("joint", "independent"))
@pytest.mark.parametrize("vocab", (True, False))
def test_loss_and_gradients_with_history_match(vocab, mode):
    users, items, B = VOCAB[vocab]
    jcfg, tcfg = _cfgs(users, items, B, mode=mode)
    dept, cat, _ = _meta(items)
    u, it, temporal = _inputs(users, items, B)
    hist = _history(B, items, 3)
    targets = np.zeros((B, 5), np.float32)
    targets[:, 0] = 1.0
    np_params = _params(jcfg)

    def jloss(p):
        logits = jmodel.apply(
            p, jcfg.model, jnp.asarray(u), jnp.asarray(it), _j(temporal),
            jnp.asarray(dept), jnp.asarray(cat),
            candidate_attention=mode == "joint", deterministic=False,
            rng=jax.random.PRNGKey(3), history=jnp.asarray(hist))
        return jstep.bce_loss(logits, jnp.asarray(targets))

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(_j(np_params))
    params = params_from_numpy(np_params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    logits = tmodel.apply(
        params, tcfg.model, torch.from_numpy(u), torch.from_numpy(it),
        _t(temporal), torch.from_numpy(dept), torch.from_numpy(cat),
        candidate_attention=mode == "joint", deterministic=False,
        rng=torch.Generator().manual_seed(3), history=torch.from_numpy(hist))
    loss = tstep.bce_loss(logits, torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    _assert_tree_close(grads, jgrads, 1e-5, "grads")
    index = {id(p): k for k, p in enumerate(leaves)}
    for n in "qkvo":                 # the loss reaches the sequence block
        k = index[id(params["sequence_attn"][n]["w"])]
        assert float(grads[k].abs().max()) > 0


@pytest.mark.parametrize("with_hour", (True, False))
@pytest.mark.parametrize("with_history", (True, False))
def test_score_items_with_hour_and_history(with_hour, with_history):
    users, items, _ = VOCAB[True]
    jcfg, tcfg = _cfgs(users, items, 17)
    np_params = _params(jcfg)
    rng = np.random.default_rng(4)
    u = rng.integers(0, users, 17).astype(np.int32)
    it = rng.integers(0, items, 17).astype(np.int32)
    hour = rng.integers(0, 24, 17).astype(np.int32) if with_hour else None
    hist = _history(17, items, 5) if with_history else None
    want = jmodel.score_items_with_hour(
        _j(np_params), jcfg.model, jnp.asarray(u), jnp.asarray(it),
        None if hour is None else jnp.asarray(hour),
        None if hist is None else jnp.asarray(hist))
    got = tmodel.score_items_with_hour(
        params_from_numpy(np_params, "cpu"), tcfg.model, torch.from_numpy(u),
        torch.from_numpy(it), None if hour is None else torch.from_numpy(hour),
        None if hist is None else torch.from_numpy(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------- training

def _log(users, items, seed=0):
    kw = dict(num_users=users, num_items=items, num_days=30,
              avg_txns_per_user=6, seed=seed)
    return generate_interactions(**kw), jgenerate(**kw)


def test_history_tables_match_the_reference():
    inter, jinter = _log(*VOCAB[True][:2])
    for n in (1, H, 50):
        np.testing.assert_array_equal(inter.recent_history(n),
                                      jinter.recent_history(n))
        np.testing.assert_array_equal(inter.causal_history(n),
                                      jinter.causal_history(n))
    assert isinstance(jinter, JInteractions)


def _batches(inter, B, K, causal):
    extra = {"history": inter.causal_history(H)} if causal else None
    it = BatchIterator(inter, B, seed=0, extra_cols=extra)
    out, epoch = [], 0
    while len(out) < K:
        out.extend(it.epoch(epoch))
        epoch += 1
    return out[:K]


@pytest.mark.parametrize("causal,mode,sampling", [
    (False, "joint", "iid"), (False, "independent", "stratified"),
    (True, "independent", "iid")])
def test_three_steps_with_history_match(causal, mode, sampling):
    users, items, B = VOCAB[True]
    K = 3
    jcfg, tcfg = _cfgs(users, items, B, mode=mode, sampling=sampling)
    jcfg.model.causal_history = tcfg.model.causal_history = causal
    dept, cat, cdf = _meta(items)
    inter, _ = _log(users, items)
    table = inter.recent_history(H)
    batches = _batches(inter, B, K, causal)
    np_params = _params(jcfg)

    opt = joptim.make_optimizer(jcfg.train, steps_per_epoch=K)
    jparams = _j(np_params)
    jstate = opt.init(jparams)
    jrun = jstep.make_train_step(jmodel, jcfg, opt, jnp.asarray(cdf),
                                 jnp.asarray(dept), jnp.asarray(cat),
                                 None if causal else jnp.asarray(table))
    sample = (jsampler.sample_negatives_stratified if sampling == "stratified"
              else jsampler.sample_negatives)
    key = jax.random.PRNGKey(5)
    negs, jm = [], []
    for b in batches:
        _, step_rng = jax.random.split(key)
        rng_neg, _ = jax.random.split(step_rng)
        negs.append(np.asarray(sample(
            rng_neg, jnp.asarray(b["item_ids"]), items, 4,
            cdf=jnp.asarray(cdf))))
        jparams, jstate, key, m = jrun(jparams, jstate, key, _j(b))
        jm.append({k: float(v) for k, v in m.items()})

    params = params_from_numpy(np_params, "cpu")
    topt = toptim.make_optimizer(tcfg.train, steps_per_epoch=K)
    state = adam_state_from_numpy(jax.tree.map(np.asarray, joptim.make_optimizer(
        jcfg.train, K).init(_j(np_params))), "cpu")
    multi = tstep.make_multi_train_step(
        tmodel, tcfg, topt, cdf, dept, cat, None if causal else table,
        device="cpu")
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    assert ("history" in stacked) == causal
    params, state, _, metrics = multi(params, state, torch.Generator(),
                                      stacked, np.stack(negs))
    _assert_tree_close(params, jparams, 5e-5, "params")
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    _assert_tree_close(state["mu"], adam.mu, 5e-5, "mu")
    _assert_tree_close(state["nu"], adam.nu, 5e-5, "nu")
    want = {k: np.mean([m[k] for m in jm]) for k in jm[0]}
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=1e-5)
    for k in ("accuracy", "pos_accuracy", "neg_accuracy"):
        assert abs(float(metrics[k]) - want[k]) <= 1.0 / B


@pytest.mark.parametrize("mode", ("joint", "independent"))
def test_eval_step_with_history_matches(mode):
    users, items, B = VOCAB[True]
    jcfg, tcfg = _cfgs(users, items, B, mode=mode)
    dept, cat, cdf = _meta(items)
    inter, _ = _log(users, items)
    table = inter.recent_history(H)
    b = _batches(inter, B, 1, causal=True)[0]     # eval ignores batch history
    np_params = _params(jcfg)
    key = jax.random.PRNGKey(7)
    _, step_rng = jax.random.split(key)
    negs = np.array(jsampler.sample_negatives(
        step_rng, jnp.asarray(b["item_ids"]), items, 4, cdf=jnp.asarray(cdf)))
    jeval = jstep.make_eval_step(jmodel, jcfg, jnp.asarray(cdf),
                                 jnp.asarray(dept), jnp.asarray(cat),
                                 jnp.asarray(table))
    _, want = jeval(_j(np_params), key, _j(b))
    teval = tstep.make_eval_step(tmodel, tcfg, cdf, dept, cat, table,
                                 device="cpu")
    _, got = teval(params_from_numpy(np_params, "cpu"), torch.Generator(), b,
                   negs)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("accuracy", "pos_accuracy", "neg_accuracy"):
        assert abs(float(got[k]) - float(want[k])) <= 1.0 / B


# --------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def seq_model():
    users, items = 300, 120
    jcfg, tcfg = _cfgs(users, items, 64)
    np_params = _params(jcfg, seed=2)
    rng = np.random.default_rng(9)
    hist = _history(users, items, 11)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    return jcfg, tcfg, np_params, hist, dept, cat


TEMPORAL = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}


def _same(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("temporal", (None, TEMPORAL))
def test_sequence_scorer_matches(seq_model, temporal):
    jcfg, tcfg, np_params, hist, dept, cat = seq_model
    js = JSeqScorer(_j(np_params), jcfg.model, jnp.asarray(dept),
                    jnp.asarray(cat), user_history=hist, sample_users=100)
    ts = SequenceRescoreScorer(params_from_numpy(np_params, "cpu"),
                               tcfg.model, torch.from_numpy(dept),
                               torch.from_numpy(cat), user_history=hist,
                               sample_users=100)
    np.testing.assert_allclose(ts._seq_ctx.numpy(), np.asarray(js._seq_ctx),
                               rtol=0, atol=1e-5)
    users = np.asarray([0, 7, 150, 299])
    _same(ts.topk_for_users(users, k=10, temporal=temporal),
          js.topk_for_users(users, k=10, temporal=temporal))
    exclude = np.asarray([[1, 2, 3], [4, -1, -1], [5, 6, 7], [-1, -1, -1]])
    exclude[0] = ts.topk_for_users(users[:1], k=3)[1][0]
    got = ts.topk_for_users(users, k=10, temporal=temporal, exclude=exclude)
    _same(got, js.topk_for_users(users, k=10, temporal=temporal,
                                 exclude=exclude))
    assert not set(exclude[0]) & set(got[1][0])
    items = np.asarray([0, 5, 119, 60])
    np.testing.assert_allclose(
        ts.score_pairs(users, items, temporal),
        js.score_pairs(users, items, temporal), rtol=0, atol=1e-5)
    _same(ts.topk_for_users_hourly(users, hour=8, k=5),
          js.topk_for_users_hourly(users, hour=8, k=5))


def test_model_server_with_user_history(seq_model):
    jcfg, tcfg, np_params, hist, dept, cat = seq_model
    js = JServer(jcfg, params=_j(np_params), item_dept=dept, item_cat=cat,
                 user_history=hist)
    ts = ModelServer(tcfg, params=params_from_numpy(np_params, "cpu"),
                     item_dept=dept, item_cat=cat, user_history=hist,
                     device="cpu")
    try:
        assert isinstance(ts.scorer, SequenceRescoreScorer)
        _same(ts.recommend(11, k=5)[:2], js.recommend(11, k=5)[:2])
        _same(ts.recommend(11, k=5, temporal=TEMPORAL,
                           exclude_items=[1, 2])[:2],
              js.recommend(11, k=5, temporal=TEMPORAL,
                           exclude_items=[1, 2])[:2])
        users = np.arange(0, 300, 7)
        _same(ts.recommend_batch(users, k=10)[:2],
              js.recommend_batch(users, k=10)[:2])
        np.testing.assert_allclose(ts.get_predictions(42, [3, 4, 5]),
                                   js.get_predictions(42, [3, 4, 5]),
                                   rtol=0, atol=1e-5)
    finally:
        js.close()
        ts.close()


# ------------------------------------------------------------- conversion

def test_sequence_params_and_adam_state_convert_both_ways():
    jcfg, _ = _cfgs(*VOCAB[True])
    params = jmodel.init(jax.random.PRNGKey(4), jcfg.model)
    tx = joptim.make_optimizer(jcfg.train, steps_per_epoch=10)
    state = tx.init(params)
    grads = jax.tree.map(lambda p: p * 0.5 + 0.1, params)
    _, state = tx.update(grads, state, params)
    np_params = jax.tree.map(np.asarray, params)
    port = params_from_numpy(np_params, "cpu")
    assert port["sequence_attn"]["q"]["w"].shape == (8, 8)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(port)),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    np_state = jax.tree.map(np.asarray, state)
    tstate = adam_state_from_numpy(np_state, "cpu")
    assert "sequence_attn" in tstate["mu"]
    back = adam_state_to_numpy(tstate, state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_state)):
        np.testing.assert_array_equal(a, b)
