"""Port parity for the evaluators: ``evals/metrics.py``, the host eval
sampler of ``data/sampler.py``, ``evals/evaluate.py`` and
``evals/full_eval.py`` against ``ncf_tpu`` on the CPU, from the same
numpy-seeded inputs and the same weights (moved across as numpy arrays
through ``ncf_tpu_torch/convert.py``).

Tolerances.  Candidate sets, exclusion pairs and histories are equal;
metric values within 1e-6.  In f32, ranks are equal and scores within
1e-5 (f32 sums in another order).  In bf16 (both protocols, the plain
tower) the JAX side is compiled with XLA's excess precision off, so that
every bf16 cast its code writes rounds, as it does in the port (left on,
XLA CPU keeps f32 through fused casts and every score moves by up to
~4e-3).  Scores are then within 1e-3 (one bf16 rounding that flips on an
f32 sum in another order moves a logit by ~2e-4), and ranks are equal
for every user without near ties: entries within twice the largest
score difference measured between the packages of the positive's score
(a user's rank may move by at most their count, and a metric by at most
the share of users that have any).  The port's full-catalog evaluator is
held to its naive whole-catalog oracle by the reference's own rule
(``tests/test_full_eval.py``: at least 99% of ranks equal, none more
than 2 apart), since the split first layer sums in another order than
the model's concatenated one.
"""

import functools
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ncf_tpu.native as jnative  # noqa: E402
from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgen  # noqa: E402
from ncf_tpu.evals import full_eval as jfull  # noqa: E402
from ncf_tpu.evals import metrics as jmetrics  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.utils.config import ModelConfig as JModelConfig  # noqa: E402
import ncf_tpu_torch.native as tnative  # noqa: E402
from ncf_tpu_torch.convert import (params_from_numpy,  # noqa: E402
                                   params_to_numpy)
from ncf_tpu_torch.data import generate_interactions  # noqa: E402
from ncf_tpu_torch.data import sampler as tsampler  # noqa: E402
from ncf_tpu_torch.evals import full_eval as tfull  # noqa: E402
from ncf_tpu_torch.evals import metrics as tmetrics  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ncf_tpu_torch.utils.config import ModelConfig  # noqa: E402

# the packages' ``evals`` export the function ``evaluate`` under the
# module's name
jeval = importlib.import_module("ncf_tpu.evals.evaluate")
teval = importlib.import_module("ncf_tpu_torch.evals.evaluate")
DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "demo", "checkpoint")
SCORE_TOL = 1e-5
BF16_SCORE_TOL = 1e-3
METRIC_TOL = 1e-6
SMALL = dict(mf_dim=16, mlp_dim=16, temporal_dim=8, mlp_hidden_dims=[32, 16],
             num_heads=2, history_len=8, fused_tower="off",
             compute_dtype="float32")


def _setup(use_sequence=False, seed=0, compute_dtype="float32"):
    """One synthetic log in both packages, small configs of its sizes and
    the JAX package's initial weights in both."""
    kw = dict(num_users=120, num_items=90, num_days=40,
              avg_txns_per_user=12, seed=seed)
    jinter, tinter = jgen(**kw), generate_interactions(**kw)
    sizes = dict(num_users=jinter.num_users, num_items=jinter.num_items,
                 num_departments=jinter.num_departments,
                 num_categories=jinter.num_categories,
                 use_sequence=use_sequence,
                 **dict(SMALL, compute_dtype=compute_dtype))
    jcfg, tcfg = JModelConfig(**sizes), ModelConfig(**sizes)
    np_params = jax.tree.map(np.asarray,
                             jmodel.init(jax.random.PRNGKey(seed), jcfg))
    loo_train, eval_users, eval_items = jinter.leave_one_out()
    hist = loo_train.recent_history(jcfg.history_len) if use_sequence else None
    return {"jinter": jinter, "tinter": tinter, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jax.tree.map(jnp.asarray, np_params),
            "tparams": params_from_numpy(np_params, "cpu"),
            "users": eval_users, "items": eval_items, "hist": hist,
            "dept": jinter.item_dept, "cat": jinter.item_cat}


@pytest.fixture(scope="module", params=[
    (False, "float32"), (True, "float32"), (False, "bfloat16"),
    (True, "bfloat16")], ids=["plain", "sequence", "plain-bf16",
                              "sequence-bf16"])
def setup(request):
    use_sequence, dtype = request.param
    return _setup(use_sequence, compute_dtype=dtype)


def _round_as_written(monkeypatch, s):
    """In bf16, compile the JAX side (every ``jax.jit`` the test builds)
    with XLA's excess precision off, so that its bf16 casts round."""
    if s["tcfg"].compute_dtype == "float32":
        return False
    monkeypatch.setattr(jax, "jit", functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}))
    return True


def _near_ties(ref, pos, gap, hist=None):
    """Per user: the entries of the reference scores ``ref`` [U, N] (the
    positive's own, column ``pos``, left out), and of its history pairs
    ``hist`` = (user row, item) where given, that lie within ``2 * gap``
    of the positive's score."""
    rows = np.arange(len(pos))
    sp = ref[rows, pos]
    near = np.abs(ref - sp[:, None]) <= 2 * gap
    near[rows, pos] = False
    out = near.sum(1)
    if hist is not None:
        hu, hi = hist
        out += np.bincount(hu, np.abs(ref[hu, hi] - sp[hu]) <= 2 * gap,
                           len(pos)).astype(out.dtype)
    return out


def _hold_ranks(got, want, near):
    """Ranks equal but for near ties: each user's rank moves by at most
    their count.  Returns the share of users that have any."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert (diff <= near).all(), (diff[diff > near], near[diff > near])
    return float((near > 0).mean())


def _hold_metrics(got, want, share):
    """Metric dicts equal up to ``share`` (each user's term lies in
    [0, 1])."""
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= share + METRIC_TOL, (k, got[k],
                                                             want[k])


def _block_scores(score, es, B, tensor):
    """``score``'s logits for every user of the eval set ``es`` in the
    evaluators' blocks of ``B`` (the last padded with its first row)."""
    out = []
    for start in range(0, len(es.users), B):
        sl = slice(start, start + B)
        u, c = es.users[sl], es.candidates[sl]
        t = {k: v[sl] for k, v in es.temporal.items()}
        n = len(u)
        if n < B:
            u = np.concatenate([u, u[:1].repeat(B - n)])
            c = np.concatenate([c, c[:1].repeat(B - n, axis=0)])
            t = {k: np.concatenate([v, v[:1].repeat(B - n)])
                 for k, v in t.items()}
        s = score(tensor(u), tensor(c), {k: tensor(v) for k, v in t.items()})
        out.append(np.asarray(s, np.float32)[:n])
    return np.concatenate(out)


def _positive_ranks(s):
    """The pessimistic rank of column 0 among the rest."""
    return np.maximum((s[:, 1:] > s[:, :1]).sum(1),
                      (s[:, 1:] >= s[:, :1]).sum(1))


def _eval_sets(s, num_negatives=20, seed=5):
    js = jeval.EvalSet.build(s["jinter"], s["users"], s["items"],
                             num_negatives=num_negatives, seed=seed)
    ts = teval.EvalSet.build(s["tinter"], s["users"], s["items"],
                             num_negatives=num_negatives, seed=seed)
    return js, ts


# ------------------------------------------------------------- sampling

@pytest.mark.parametrize("native", [True, False],
                         ids=["native", "numpy"])
def test_eval_set_candidates_are_identical(monkeypatch, native):
    s = _setup(False, seed=2)
    assert tnative.available() == jnative.available()
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    js, ts = _eval_sets(s, num_negatives=30, seed=9)
    np.testing.assert_array_equal(ts.users, js.users)
    np.testing.assert_array_equal(ts.candidates, js.candidates)
    assert ts.candidates.dtype == np.int32
    assert ts.temporal.keys() == js.temporal.keys()
    for k in js.temporal:
        np.testing.assert_array_equal(ts.temporal[k], js.temporal[k])
    # every negative lies outside the user's full history
    offsets, hist = s["tinter"].user_histories()
    for r, u in enumerate(ts.users):
        seen = set(hist[offsets[u]:offsets[u + 1]].tolist())
        assert not seen & set(ts.candidates[r, 1:].tolist())


def test_membership_and_padded_histories():
    s = _setup(False, seed=4)
    offsets, hist = s["tinter"].user_histories()
    rng = np.random.default_rng(0)
    users = rng.integers(0, s["tinter"].num_users, 3000)
    items = rng.integers(0, s["tinter"].num_items, 3000).astype(np.int32)
    items[:200] = hist[offsets[users[:200]]]          # certain members
    got = tsampler._membership(users, items, offsets, hist)
    np.testing.assert_array_equal(
        got, jsampler._membership(users, items, offsets, hist))
    assert got[:200].all()
    want = np.array([items[j] in set(hist[offsets[u]:offsets[u + 1]])
                     for j, u in enumerate(users)])
    np.testing.assert_array_equal(got, want)
    for max_len in (1, 5, 40):
        ph = tsampler.padded_histories(offsets, hist, users[:50], max_len)
        assert ph.dtype == np.int32 and ph.shape == (50, max_len)
        np.testing.assert_array_equal(
            ph, jsampler.padded_histories(offsets, hist, users[:50], max_len))


# -------------------------------------------------------------- metrics

def test_metrics_from_ranks_and_sample_eval_users():
    rng = np.random.default_rng(1)
    ranks = rng.integers(0, 60, 500)
    got = teval.metrics_from_ranks(ranks, ks=(1, 3, 10, 50))
    want = jeval.metrics_from_ranks(ranks, ks=(1, 3, 10, 50))
    assert got == want
    users = np.arange(1000, dtype=np.int32)
    items = users * 3
    for n in (0, 10, 999, 1000, 5000):
        for a, b in zip(teval.sample_eval_users(users, items, n, seed=3),
                        jeval.sample_eval_users(users, items, n, seed=3)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("C", [1, 7, 40])
def test_general_metrics_match(C):
    rng = np.random.default_rng(C)
    scores = rng.normal(size=(64, C)).astype(np.float32)
    targets = (rng.random((64, C)) < 0.2).astype(np.float32)
    targets[:5] = 0.0                                   # rows with none
    ts, tt = torch.from_numpy(scores), torch.from_numpy(targets)
    js, jt = jnp.asarray(scores), jnp.asarray(targets)
    for k in sorted({1, min(5, C), C}):
        for name in ("hit_rate_at_k", "ndcg_at_k", "mrr_at_k", "map_at_k"):
            got = float(getattr(tmetrics, name)(ts, tt, k))
            want = float(getattr(jmetrics, name)(js, jt, k))
            assert abs(got - want) <= METRIC_TOL, (name, k, got, want)
    got, want = float(tmetrics.auc(ts, tt)), float(jmetrics.auc(js, jt))
    assert abs(got - want) <= METRIC_TOL
    gm = tmetrics.calculate_metrics(ts, tt, ks=(1, 5, 10))
    jm = jmetrics.calculate_metrics(js, jt, ks=(1, 5, 10))
    assert gm.keys() == jm.keys()
    for k in jm:
        assert abs(float(gm[k]) - float(jm[k])) <= METRIC_TOL, k
    # AUC without both classes is 0.5
    assert float(tmetrics.auc(ts, torch.zeros_like(tt))) == 0.5


# ----------------------------------------------------- sampled protocol

def test_sampled_protocol_matches(setup, monkeypatch):
    s = setup
    bf16 = _round_as_written(monkeypatch, s)
    js, ts = _eval_sets(s)
    kw = dict(item_dept=s["dept"], item_cat=s["cat"], user_history=s["hist"])
    # the scores of every user in the evaluators' blocks, then the ranks
    # of every entry point
    jscore = jeval.make_score_fn(jmodel, s["jparams"], s["jcfg"], **kw)
    tscore = teval.make_score_fn(tmodel, s["tparams"], s["tcfg"],
                                 device="cpu", **kw)
    want = _block_scores(jscore, ts, 32, jnp.asarray)
    got = _block_scores(tscore, ts, 32, torch.from_numpy)
    gap = float(np.abs(got - want).max())
    assert gap <= (BF16_SCORE_TOL if bf16 else SCORE_TOL), gap

    jranks = jeval.DeviceEvaluator(jmodel, s["jcfg"], js, batch_size=32,
                                   **kw).ranks(s["jparams"])
    dev = teval.DeviceEvaluator(tmodel, s["tcfg"], ts, batch_size=32,
                                device="cpu", **kw)
    tranks = dev.ranks(s["tparams"])
    assert tranks.shape == jranks.shape == (len(s["users"]),)
    # the evaluators ranked these scores
    np.testing.assert_array_equal(jranks, _positive_ranks(want))
    np.testing.assert_array_equal(tranks, _positive_ranks(got))
    share = 0.0
    if bf16:
        share = _hold_ranks(tranks, jranks,
                            _near_ties(want, np.zeros(len(want), int), gap))
    else:
        np.testing.assert_array_equal(tranks, jranks)
    want_m = jeval.metrics_from_ranks(jranks)
    _hold_metrics(dev(s["tparams"]), want_m, share)
    # the host loop, with a ragged last block
    got_m = teval.evaluate(tscore, ts, batch_size=37, device="cpu")
    _hold_metrics(got_m, jeval.evaluate(jscore, js, batch_size=37), share)
    _hold_metrics(got_m, want_m, share)


def test_sampled_protocol_ranks_constant_scores_pessimistically():
    s = _setup(False, seed=6)
    _, ts = _eval_sets(s, num_negatives=11)
    zeros = params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                     params_to_numpy(s["tparams"])), "cpu")
    ranks = teval.DeviceEvaluator(tmodel, s["tcfg"], ts, batch_size=50,
                                  device="cpu").ranks(zeros)
    np.testing.assert_array_equal(ranks, np.full(len(ts.users), 11))


# -------------------------------------------------------- full protocol

def test_exclusion_pairs_match_and_dedupe():
    s = _setup(False, seed=3)
    for items in (None, s["items"]):
        got = tfull.exclusion_pairs(s["tinter"], s["users"], items)
        want = jfull.exclusion_pairs(s["jinter"], s["users"], items)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    u_idx, items = tfull.exclusion_pairs(s["tinter"], s["users"])
    assert len(set(zip(u_idx.tolist(), items.tolist()))) == len(u_idx)
    inter = s["tinter"]
    for local in (0, 7, len(s["users"]) - 1):
        expect = set(inter.item_ids[inter.user_ids
                                    == s["users"][local]].tolist())
        assert set(items[u_idx == local].tolist()) == expect
    u2, i2 = tfull.exclusion_pairs(s["tinter"], s["users"], s["items"])
    assert not ((i2 == s["items"][u2]).any())          # positives dropped
    assert len(u2) == len(u_idx) - len(s["users"])
    np.testing.assert_array_equal(
        tfull._pad_to(np.arange(3), 5, -1), [0, 1, 2, -1, -1])
    np.testing.assert_array_equal(tfull._pad_to(np.arange(6), 4, -1),
                                  np.arange(4))


def _catalog_scores(model, params, cfg, s, Bu, tensor, **kw):
    """The model's ``score_candidates`` logits of every eval user against
    the whole catalog [U, V], in blocks of ``Bu`` users as
    ``full_ranks_naive`` forms them."""
    V = cfg.num_items
    temporal = jfull._eval_temporal(s["jinter"], s["users"])
    out = []
    for start in range(0, len(s["users"]), Bu):
        users = s["users"][start:start + Bu]
        t = {k: tensor(v[start:start + Bu]) for k, v in temporal.items()}
        extra = {}
        if cfg.use_sequence:
            extra["history"] = tensor(s["hist"][users])
        cand = np.tile(np.arange(V, dtype=np.int32), (len(users), 1))
        out.append(np.asarray(model.score_candidates(
            params, cfg, tensor(users), tensor(cand), t, tensor(s["dept"]),
            tensor(s["cat"]), **extra, **kw), np.float32))
    return np.concatenate(out)


@pytest.mark.parametrize("blocks", [(32, 32, 1 << 16), (17, 41, 97)],
                         ids=["even", "odd"])
def test_full_protocol_matches(setup, blocks, monkeypatch):
    s = setup
    bf16 = _round_as_written(monkeypatch, s)
    Bu, C, chunk = blocks
    kw = dict(user_history=s["hist"], item_dept=s["dept"],
              item_cat=s["cat"])
    jranks = np.asarray(jfull.FullCatalogEvaluator(
        s["jcfg"], s["jinter"], s["users"], s["items"], user_block=Bu,
        item_block=C, pair_chunk=chunk, **kw).ranks(s["jparams"]))
    ev = tfull.FullCatalogEvaluator(
        s["tcfg"], s["tinter"], s["users"], s["items"], user_block=Bu,
        item_block=C, pair_chunk=chunk, device="cpu", **kw)
    tranks = ev.ranks(s["tparams"])
    assert tranks.shape == (len(s["users"]),)

    jnaive = jfull.full_ranks_naive(jmodel, s["jparams"], s["jcfg"],
                                    s["jinter"], s["users"], s["items"],
                                    user_block=Bu, **kw)
    tnaive = tfull.full_ranks_naive(tmodel, s["tparams"], s["tcfg"],
                                    s["tinter"], s["users"], s["items"],
                                    user_block=Bu, device="cpu", **kw)
    share = 0.0
    if bf16:
        # the gap between the packages' whole-catalog scores, which both
        # split evaluators replicate
        want = _catalog_scores(jmodel, s["jparams"], s["jcfg"], s, Bu,
                               jnp.asarray)
        with torch.no_grad():
            got = _catalog_scores(tmodel, s["tparams"], s["tcfg"], s, Bu,
                                  torch.from_numpy)
        gap = float(np.abs(got - want).max())
        assert gap <= BF16_SCORE_TOL, gap
        near = _near_ties(want, s["items"], gap, tfull.exclusion_pairs(
            s["tinter"], s["users"]))
        share = _hold_ranks(tranks, jranks, near)
        _hold_ranks(tnaive, jnaive, near)
    else:
        np.testing.assert_array_equal(tranks, jranks)
        np.testing.assert_array_equal(tnaive, jnaive)
    m = ev(s["tparams"])
    assert m.pop("eval_protocol_full") == 1.0
    _hold_metrics(m, jeval.metrics_from_ranks(jranks), share)
    # the split evaluator against its oracle: the reference's own rule
    assert (tranks == tnaive).mean() >= 0.99
    assert np.abs(tranks.astype(np.int64) - tnaive).max() <= 2


def test_full_protocol_ranks_constant_scores_pessimistically():
    s = _setup(False, seed=0)
    zeros = params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                     params_to_numpy(s["tparams"])), "cpu")
    ev = tfull.FullCatalogEvaluator(
        s["tcfg"], s["tinter"], s["users"], s["items"],
        item_dept=s["dept"], item_cat=s["cat"], user_block=32,
        item_block=64, device="cpu")
    ranks = ev.ranks(zeros)
    assert teval.metrics_from_ranks(ranks)["hr@10"] == 0.0
    # catalog minus the positive minus the rest of the user's history
    u_idx, _ = tfull.exclusion_pairs(s["tinter"], s["users"], s["items"])
    hist_sizes = np.bincount(u_idx, minlength=len(s["users"]))
    np.testing.assert_array_equal(ranks, s["tcfg"].num_items - 1 - hist_sizes)


# ------------------------------------------------- the demo checkpoint

def test_demo_checkpoint_gives_the_same_ranks_in_both_packages():
    template = tmodel.init(torch.Generator(), ModelConfig(), device="meta")
    state, _ = tckpt.restore(DEMO, {"params": template}, "cpu")
    np_params = params_to_numpy(state["params"])
    jcfg, tcfg = JModelConfig(), ModelConfig()
    jcfg.compute_dtype = tcfg.compute_dtype = "float32"
    jcfg.fused_tower = tcfg.fused_tower = "off"
    kw = dict(num_users=jcfg.num_users, num_items=jcfg.num_items,
              num_days=60, avg_txns_per_user=6, seed=21)
    jinter, tinter = jgen(**kw), generate_interactions(**kw)
    assert (jinter.num_users, jinter.num_items) == (jcfg.num_users,
                                                    jcfg.num_items)
    rng = np.random.default_rng(0)
    dept = rng.integers(0, jcfg.num_departments, jcfg.num_items).astype(
        np.int32)
    cat = rng.integers(0, jcfg.num_categories, jcfg.num_items).astype(
        np.int32)
    _, users, items = jinter.leave_one_out()
    users, items = jeval.sample_eval_users(users, items, 200, seed=1)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")

    js = jeval.EvalSet.build(jinter, users, items, num_negatives=100, seed=3)
    ts = teval.EvalSet.build(tinter, users, items, num_negatives=100, seed=3)
    np.testing.assert_array_equal(ts.candidates, js.candidates)
    jranks = jeval.DeviceEvaluator(jmodel, jcfg, js, batch_size=64,
                                   item_dept=dept, item_cat=cat).ranks(jp)
    tranks = teval.DeviceEvaluator(tmodel, tcfg, ts, batch_size=64,
                                   item_dept=dept, item_cat=cat,
                                   device="cpu").ranks(tp)
    np.testing.assert_array_equal(tranks, jranks)
    assert (teval.metrics_from_ranks(tranks)
            == jeval.metrics_from_ranks(jranks))

    jfranks = np.asarray(jfull.FullCatalogEvaluator(
        jcfg, jinter, users, items, item_dept=dept, item_cat=cat,
        user_block=64, item_block=128).ranks(jp))
    tfranks = tfull.FullCatalogEvaluator(
        tcfg, tinter, users, items, item_dept=dept, item_cat=cat,
        user_block=64, item_block=128, device="cpu").ranks(tp)
    np.testing.assert_array_equal(tfranks, jfranks)
    assert (teval.metrics_from_ranks(tfranks)
            == jeval.metrics_from_ranks(jfranks))
    # the trained model ranks its held-out positives above chance
    assert teval.metrics_from_ranks(tranks)["hr@10"] > 10 / 101
