"""Port parity for the training slice: AdvancedNCF in training mode, the
loss and its gradients, and whole optimizer steps against ``ncf_tpu`` at
a small size (8-wide tables, tower [16, 8], 2 heads, 4 negatives).

- Loss and gradients with dropout 0, in both vocab branches and both
  candidate modes: loss within rtol 1e-5, every gradient leaf within
  1e-5 of its largest magnitude (f32 sums in another order; a floor of
  1e-7 of the largest gradient for leaves that are zero in exact
  arithmetic and come out as rounding noise).
- Three full steps (sampling, forward, backward, clip, L2 decay, Adam,
  schedule) in f32 with dropout 0, the port handed the negatives the JAX
  step draws: params and Adam moments within 5e-5 of their largest
  magnitude per leaf (an Adam step divides by sqrt(v), which amplifies
  the last-bit differences of tiny gradients), the count exact, the mean
  metrics within rtol 1e-5 (accuracies within one decision in the batch).
- Dropout 0.2: the masks come from different generators, so each package
  trains 30 steps on the same data from the same params with its own
  random numbers; the mean losses of the last 10 steps agree within 0.01
  (both seeded, so the test is deterministic).

Table gradients: on the CPU the reference's XLA route sums a bf16 table's
gradient in bf16, while the port follows the TPU kernel and sums in f32,
so step parity runs in f32 (bf16 is held per kernel).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.train import step as jstep  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                   params_from_numpy, params_to_numpy,
                                   tree_leaves)
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

TEMPORAL = ("hour", "day", "month", "day_of_year")
VOCAB = {True: (100, 60, 64), False: (400, 300, 16)}   # users, items, batch


def _cfgs(users, items, batch, **over):
    out = []
    for cfg in (JConfig(), Config()):
        m, t = cfg.model, cfg.train
        m.num_users, m.num_items = users, items
        m.mf_dim = m.mlp_dim = 8
        m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
        m.num_departments, m.num_categories = 3, 5
        m.negative_samples, m.fused_tower = 4, "off"
        m.compute_dtype = over.get("dtype", "float32")
        m.dropout = over.get("dropout", 0.0)
        m.candidate_mode = over.get("mode", "joint")
        t.batch_size, t.num_epochs = batch, 1
        t.loss = over.get("loss", "bce")
        t.lr_schedule = over.get("schedule", "constant")
        t.warmup_steps = over.get("warmup", 0)
        t.weight_decay = over.get("wd", 1e-5)
        t.gradient_clip_norm = over.get("clip", 5.0)
        t.negative_sampling = over.get("sampling", "iid")
        out.append(cfg)
    return out


def _meta(items, seed=0):
    rng = np.random.default_rng(seed)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    w = 1.0 / rng.zipf(1.3, items).astype(np.float64)
    return dept, cat, np.array(jsampler.make_sampling_cdf(w))


def _params(jcfg, seed=0):
    """The reference's init with every leaf moved off its init value
    (zero biases included), so that the L2 term outweighs the rounding
    noise of gradients that are zero in exact arithmetic."""
    tree = jmodel.init(jax.random.PRNGKey(seed), jcfg.model)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(
            np.float32), tree)


def _assert_tree_close(got, want, rel, what):
    """Per leaf within ``rel`` of its largest magnitude, with a floor of
    1e-7 of the tree's largest (a leaf that is zero in exact arithmetic,
    like the attention key bias under the softmax, is rounding noise in
    both packages)."""
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


@pytest.mark.parametrize("vocab", (True, False))
@pytest.mark.parametrize("mode", ("joint", "independent"))
def test_loss_and_gradients_match(vocab, mode):
    users, items, B = VOCAB[vocab]
    jcfg, tcfg = _cfgs(users, items, B, mode=mode)
    assert jmodel._use_vocab_precompute(jcfg.model, B * 5) == vocab
    dept, cat, _ = _meta(items)
    rng = np.random.default_rng(1)
    u = rng.integers(0, users, B).astype(np.int32)
    it = rng.integers(0, items, (B, 5)).astype(np.int32)
    temporal = {"hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
                "month": rng.integers(0, 12, B),
                "day_of_year": rng.integers(0, 400, B)}
    temporal = {k: v.astype(np.int32) for k, v in temporal.items()}
    targets = np.zeros((B, 5), np.float32)
    targets[:, 0] = 1.0
    np_params = _params(jcfg)

    def jloss(p):
        logits = jmodel.apply(
            p, jcfg.model, jnp.asarray(u), jnp.asarray(it),
            {k: jnp.asarray(v) for k, v in temporal.items()},
            jnp.asarray(dept), jnp.asarray(cat),
            candidate_attention=mode == "joint", deterministic=False,
            rng=jax.random.PRNGKey(3))
        return jstep.bce_loss(logits, jnp.asarray(targets))

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, np_params))

    params = params_from_numpy(np_params, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    logits = tmodel.apply(
        params, tcfg.model, torch.from_numpy(u), torch.from_numpy(it),
        {k: torch.from_numpy(v) for k, v in temporal.items()},
        torch.from_numpy(dept), torch.from_numpy(cat),
        candidate_attention=mode == "joint", deterministic=False,
        rng=torch.Generator().manual_seed(3))
    loss = tstep.bce_loss(logits, torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    _assert_tree_close(grads, jgrads, 1e-5, "grads")


def _jax_run(jcfg, np_params, batches, dept, cat, cdf, seed):
    """K reference steps; returns params, opt state, per-step metrics and
    the negatives each step drew (replaying its key splits)."""
    mcfg = jcfg.model
    opt = joptim.make_optimizer(jcfg.train, steps_per_epoch=len(batches))
    params = jax.tree.map(jnp.asarray, np_params)
    state = opt.init(params)
    step = jstep.make_train_step(jmodel, jcfg, opt, jnp.asarray(cdf),
                                 jnp.asarray(dept), jnp.asarray(cat))
    sample = (jsampler.sample_negatives_stratified
              if jcfg.train.negative_sampling == "stratified"
              else jsampler.sample_negatives)
    key = jax.random.PRNGKey(seed)
    negs, metrics = [], []
    for b in batches:
        _, step_rng = jax.random.split(key)                 # step.py:141
        rng_neg, _ = jax.random.split(step_rng)             # step.py:78
        negs.append(np.asarray(sample(
            rng_neg, jnp.asarray(b["item_ids"]), mcfg.num_items,
            mcfg.negative_samples, cdf=jnp.asarray(cdf))))
        params, state, key, m = step(params, state, key,
                                     {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics, negs


def _batches(users, items, B, K, seed=0):
    inter = generate_interactions(num_users=users, num_items=items,
                                  num_days=30, avg_txns_per_user=6, seed=seed)
    it = BatchIterator(inter, B, seed=seed)
    out = []
    epoch = 0
    while len(out) < K:
        out.extend(it.epoch(epoch))
        epoch += 1
    return out[:K]


@pytest.mark.parametrize("loss,schedule,mode,sampling,clip", [
    ("bce", "constant", "joint", "iid", 5.0),
    ("bce", "cosine", "independent", "stratified", 0.05),
    ("bpr", "constant", "independent", "iid", 0.05),
    ("bpr", "cosine", "joint", "stratified", 5.0),
])
def test_three_steps_match(loss, schedule, mode, sampling, clip):
    users, items, B = VOCAB[True]
    K = 3
    jcfg, tcfg = _cfgs(users, items, B, loss=loss, schedule=schedule,
                       warmup=2 if schedule == "cosine" else 0, mode=mode,
                       sampling=sampling, clip=clip, wd=1e-3)
    dept, cat, cdf = _meta(items)
    batches = _batches(users, items, B, K)
    np_params = _params(jcfg)
    jparams, jstate, jmetrics, negs = _jax_run(jcfg, np_params, batches,
                                               dept, cat, cdf, seed=5)

    params = params_from_numpy(np_params, "cpu")
    opt = toptim.make_optimizer(tcfg.train, steps_per_epoch=K)
    state = adam_state_from_numpy(
        jax.tree.map(np.asarray, joptim.make_optimizer(
            jcfg.train, K).init(jax.tree.map(jnp.asarray, np_params))), "cpu")
    multi = tstep.make_multi_train_step(tmodel, tcfg, opt, cdf, dept, cat,
                                        device="cpu")
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    params, state, gen, metrics = multi(
        params, state, torch.Generator(), stacked, np.stack(negs))

    _assert_tree_close(params, jparams, 5e-5, "params")
    adam = [s for s in jstate if hasattr(s, "mu")][0]
    assert int(state["count"]) == int(adam.count) == K
    _assert_tree_close(state["mu"], adam.mu, 5e-5, "mu")
    _assert_tree_close(state["nu"], adam.nu, 5e-5, "nu")
    want = {k: np.mean([m[k] for m in jmetrics]) for k in jmetrics[0]}
    assert metrics.keys() == want.keys()
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=1e-5)
    for k in ("accuracy", "pos_accuracy", "neg_accuracy"):
        assert abs(float(metrics[k]) - want[k]) <= 1.0 / B


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("cosine", 3),
                                             ("cosine", 0)])
def test_schedule_matches_optax(schedule, warmup):
    jcfg, tcfg = _cfgs(10, 10, 8, schedule=schedule, warmup=warmup)
    jcfg.train.num_epochs = tcfg.train.num_epochs = 2
    jsched = joptim.make_schedule(jcfg.train, 7)
    tsched = toptim.make_schedule(tcfg.train, 7)
    for count in range(0, 20):
        np.testing.assert_allclose(
            float(tsched(torch.tensor(count, dtype=torch.int32))),
            float(jsched(count)), rtol=1e-6, atol=1e-12)
    if warmup:                     # the first step's rate under warm-up
        assert float(tsched(torch.tensor(0))) == 0.0


def test_unported_optimizers_raise():
    _, tcfg = _cfgs(10, 10, 8)
    tcfg.train.embedding_optimizer = "rowwise_adagrad"
    with pytest.raises(NotImplementedError):
        toptim.make_optimizer(tcfg.train)


def _train(package, cfg, np_params, batches, dept, cat, cdf, seed):
    if package == "jax":
        opt = joptim.make_optimizer(cfg.train, len(batches))
        params = jax.tree.map(jnp.asarray, np_params)
        state = opt.init(params)
        step = jstep.make_train_step(jmodel, cfg, opt, jnp.asarray(cdf),
                                     jnp.asarray(dept), jnp.asarray(cat))
        key = jax.random.PRNGKey(seed)
        losses = []
        for b in batches:
            params, state, key, m = step(
                params, state, key, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        return losses
    opt = toptim.make_optimizer(cfg.train, len(batches))
    params = params_from_numpy(np_params, "cpu")
    state = opt.init(params)
    step = tstep.make_train_step(tmodel, cfg, opt, cdf, dept, cat,
                                 device="cpu")
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for b in batches:
        params, state, gen, m = step(params, state, gen, b)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("mode,sampling", [("joint", "stratified"),
                                           ("independent", "iid")])
def test_dropout_training_converges_alike(mode, sampling):
    users, items, B = VOCAB[True]
    jcfg, tcfg = _cfgs(users, items, B, dropout=0.2, mode=mode,
                       sampling=sampling)
    jcfg.train.learning_rate = tcfg.train.learning_rate = 3e-3
    dept, cat, cdf = _meta(items)
    batches = _batches(users, items, B, 30, seed=2)
    np_params = _params(jcfg, seed=1)
    jl = _train("jax", jcfg, np_params, batches, dept, cat, cdf, seed=4)
    tl = _train("torch", tcfg, np_params, batches, dept, cat, cdf, seed=4)
    assert np.mean(tl[-10:]) < np.mean(tl[:5])          # it learns
    assert abs(np.mean(tl[-10:]) - np.mean(jl[-10:])) <= 0.01, (
        np.mean(tl[-10:]), np.mean(jl[-10:]))


def test_params_round_trip_after_training():
    users, items, B = VOCAB[True]
    _, tcfg = _cfgs(users, items, B)
    dept, cat, cdf = _meta(items)
    np_params = _params(_cfgs(users, items, B)[0])
    params = params_from_numpy(np_params, "cpu")
    opt = toptim.make_optimizer(tcfg.train, 1)
    state = opt.init(params)
    step = tstep.make_train_step(tmodel, tcfg, opt, cdf, dept, cat,
                                 device="cpu")
    b = _batches(users, items, B, 1)[0]
    params, state, _, m = step(params, state, torch.Generator(), b)
    back = params_to_numpy(params)
    for a, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        assert a.shape == w.shape and a.dtype == w.dtype
    assert np.isfinite(float(m["loss"]))
    eval_step = tstep.make_eval_step(tmodel, tcfg, cdf, dept, cat,
                                     device="cpu")
    _, em = eval_step(params, torch.Generator(), b)
    assert set(em) == {"loss", "accuracy", "pos_accuracy", "neg_accuracy"}


@pytest.mark.parametrize("mode,loss", [("joint", "bce"),
                                       ("independent", "bpr")])
def test_eval_step_matches(mode, loss):
    """Validation with the reference's own iid draw (replaying its key
    split): loss within rtol 1e-5, accuracies within one decision."""
    users, items, B = VOCAB[True]
    jcfg, tcfg = _cfgs(users, items, B, mode=mode, loss=loss,
                       sampling="stratified")
    dept, cat, cdf = _meta(items)
    b = _batches(users, items, B, 1)[0]
    np_params = _params(jcfg)
    key = jax.random.PRNGKey(7)
    _, step_rng = jax.random.split(key)                     # step.py:479
    negs = np.array(jsampler.sample_negatives(
        step_rng, jnp.asarray(b["item_ids"]), items,
        jcfg.model.negative_samples, cdf=jnp.asarray(cdf)))
    jeval = jstep.make_eval_step(jmodel, jcfg, jnp.asarray(cdf),
                                 jnp.asarray(dept), jnp.asarray(cat))
    _, want = jeval(jax.tree.map(jnp.asarray, np_params), key,
                    {k: jnp.asarray(v) for k, v in b.items()})
    teval = tstep.make_eval_step(tmodel, tcfg, cdf, dept, cat, device="cpu")
    _, got = teval(params_from_numpy(np_params, "cpu"), torch.Generator(), b,
                   negs)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("accuracy", "pos_accuracy", "neg_accuracy"):
        assert abs(float(got[k]) - float(want[k])) <= 1.0 / B


@pytest.mark.parametrize("mode", ("on", "interpret"))
def test_fused_tower_modes_raise_until_b4_is_ported(mode):
    users, items, B = VOCAB[True]
    _, tcfg = _cfgs(users, items, B)
    tcfg.model.fused_tower = mode
    params = params_from_numpy(_params(_cfgs(users, items, B)[0]), "cpu")
    u = torch.zeros(B, dtype=torch.int32)
    it = torch.zeros((B, 5), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B4"):
        tmodel.apply(params, tcfg.model, u, it)
    tcfg.model.fused_tower = "auto"          # the plain layers, as off a TPU
    assert tmodel.apply(params, tcfg.model, u, it).shape == (B, 5)
