"""Port parity for the table optimizers of ``train/optim.py``
(``rowwise_adagrad``, ``partial_rowwise_adam``, ``bf16_adam``, ``adam``
with its own learning rate) against ``ncf_tpu``'s ``make_optimizer``.

Five steps on a tree of two tables and dense leaves, from the same
params and the same seeded gradients.  Tolerances: params and f32 state
within rtol 1e-5, atol 1e-6 (the two packages round the same formulas
in different orders; five steps of lr 0.01-0.05 move a value by at most
a few 1e-7 of ulp noise); bf16 moments within one bf16 ulp (rtol 2^-7),
since a last-bit difference in the f32 value may round the other way;
step counts exactly.  Each state leaf is compared under the name the
JAX package's checkpoints give it, so the naming of
``checkpoint.named_opt_state`` is held here too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ncf_tpu.train.checkpoint import _path_str  # noqa: E402
from ncf_tpu.train.optim import embedding_labels as jlabels  # noqa: E402
from ncf_tpu.train.optim import make_optimizer as jmake  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (named_tree, opt_state_from_numpy,  # noqa: E402
                                   opt_state_to_numpy, params_from_numpy,
                                   tree_leaves)
from ncf_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from ncf_tpu_torch.train.optim import (Adam, TableOptimizer,  # noqa: E402
                                       embedding_labels, make_optimizer,
                                       select)
from ncf_tpu_torch.utils.config import Config  # noqa: E402

STEPS = 5
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -7


def _tree(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"attn": {"q": {"kernel": f(6, 6), "bias": f(6)}},
            "item_emb": f(9, 6),
            "mlp": [{"w": f(6, 4), "b": f(4)}, {"w": f(4, 2), "b": f(2)}],
            "user_emb": f(11, 6)}


def _cfgs(**train):
    out = []
    for cfg in (JConfig(), Config()):
        cfg.train.learning_rate = 0.01
        for k, v in train.items():
            setattr(cfg.train, k, v)
        out.append(cfg)
    return out


CASES = {
    "rowwise": dict(embedding_optimizer="rowwise_adagrad",
                    gradient_clip_norm=0.0, weight_decay=0.0),
    "rowwise_eps_init": dict(embedding_optimizer="rowwise_adagrad",
                             embedding_adagrad_eps=1e-2,
                             embedding_adagrad_init=0.1,
                             gradient_clip_norm=0.0, weight_decay=1e-3),
    "rowwise_elr_ewd_clip": dict(embedding_optimizer="rowwise_adagrad",
                                 embedding_learning_rate=0.05,
                                 embedding_weight_decay=1e-3,
                                 weight_decay=1e-3, gradient_clip_norm=0.5),
    "partial": dict(embedding_optimizer="partial_rowwise_adam",
                    gradient_clip_norm=5.0, weight_decay=1e-5),
    "partial_ewd": dict(embedding_optimizer="partial_rowwise_adam",
                        embedding_weight_decay=1e-2,
                        gradient_clip_norm=0.0, weight_decay=0.0),
    "bf16": dict(embedding_optimizer="bf16_adam", gradient_clip_norm=0.5,
                 weight_decay=1e-3),
    "bf16_elr": dict(embedding_optimizer="bf16_adam",
                     embedding_learning_rate=0.03,
                     gradient_clip_norm=0.0, weight_decay=0.0),
    "adam_elr": dict(embedding_optimizer="adam",
                     embedding_learning_rate=0.05, weight_decay=1e-3,
                     gradient_clip_norm=0.5),
    "adam_elr_ewd_cosine": dict(embedding_optimizer="adam",
                                embedding_learning_rate=0.02,
                                embedding_weight_decay=1e-3,
                                lr_schedule="cosine", warmup_steps=2,
                                num_epochs=1, gradient_clip_norm=0.0,
                                weight_decay=0.0),
}


def _run_both(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = jax.tree.map(np.asarray, _tree(rng))     # the JAX key order
    jcfg, tcfg = _cfgs(**CASES[case])
    jtx = jmake(jcfg.train, steps_per_epoch=8)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    topt = make_optimizer(tcfg.train, steps_per_epoch=8)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for _ in range(STEPS):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(tp, tree_leaves(params_from_numpy(grads, "cpu")),
                         ts)
    return jcfg, tcfg, topt, jp, js, tp, ts


def _close(got, want, what):
    got = got.detach().cpu().to(torch.float32).numpy()
    want = np.asarray(want).astype(np.float32)
    if str(np.asarray(want).dtype) == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_optimizer_matches_optax_chain(case):
    jcfg, tcfg, topt, jp, js, tp, ts = _run_both(case)
    assert isinstance(topt, TableOptimizer)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 tree_leaves(tp)):
        _close(got, want, "param " + _path_str(path))
    t = tcfg.train
    named = dict(ckpt._leaves_with_path(ckpt.named_opt_state(
        ts, t.gradient_clip_norm, t.weight_decay, t.embedding_weight_decay,
        t.embedding_learning_rate)))
    jnamed = {_path_str(p): v
              for p, v in jax.tree_util.tree_leaves_with_path(js)}
    assert set(named) == set(jnamed)
    for k, want in jnamed.items():
        if np.asarray(want).dtype == np.int32:
            assert int(named[k]) == int(want) == STEPS, k
        else:
            assert named[k].dtype == (torch.bfloat16 if str(
                np.asarray(want).dtype) == "bfloat16" else torch.float32), k
            _close(named[k], want, k)


@pytest.mark.parametrize("case", ["rowwise_elr_ewd_clip", "bf16", "partial"])
def test_table_state_converts_both_ways(case):
    jcfg, tcfg, topt, jp, js, tp, ts = _run_both(case)
    np_state = jax.tree.map(np.asarray, js)
    port = opt_state_from_numpy(np_state, "cpu")
    got = dict(ckpt._leaves_with_path(port))
    want = dict(ckpt._leaves_with_path(ckpt.opt_state_from_named(
        named_tree(jax.tree.map(np.asarray, js)))))
    assert got.keys() == want.keys()
    back = opt_state_to_numpy(port, js, tcfg.train)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      np.asarray(b).astype(np.float32))
    # the port's own state, written into the reference's, reads back equal
    mine = opt_state_to_numpy(ts, js, tcfg.train)
    again = opt_state_from_numpy(mine, "cpu")
    for (pa, a), (pb, b) in zip(ckpt._leaves_with_path(again),
                                ckpt._leaves_with_path(ts)):
        assert pa == pb
        assert torch.equal(torch.as_tensor(a).to(b.dtype), b), pa


def test_labels_and_selection_match_the_reference():
    params = _tree(np.random.default_rng(0))
    params["mf_user"] = {"embedding": np.zeros((3, 2), np.float32)}
    params = jax.tree.map(np.asarray, params)         # the JAX key order
    want = jax.tree.leaves(jlabels(jax.tree.map(jnp.asarray, params)))
    assert tree_leaves(embedding_labels(params)) == want
    tables = select(params, "embedding")
    assert sorted(tables) == ["item_emb", "mf_user", "user_emb"]
    dense = select(params, "dense")
    assert sorted(dense) == ["attn", "mlp"]
    with pytest.raises(ValueError, match="mixes"):
        select({"mlp": [{"w": 1}, {"user_emb": 2}]}, "dense")


def test_make_optimizer_routes_and_rejects():
    cfg = Config().train
    assert isinstance(make_optimizer(cfg), Adam)
    cfg.embedding_learning_rate = 0.01
    assert isinstance(make_optimizer(cfg), TableOptimizer)
    for kind in ("rowwise_adagrad", "partial_rowwise_adam", "bf16_adam"):
        cfg = Config().train
        cfg.embedding_optimizer = kind
        opt = make_optimizer(cfg)
        assert isinstance(opt, TableOptimizer) and opt.kind == kind
    cfg.embedding_optimizer = "sgd"
    with pytest.raises(ValueError, match="embedding_optimizer"):
        make_optimizer(cfg)


def test_rowwise_keeps_a_bf16_gradient_in_bf16():
    """The reference's rowwise rule returns the gradient's dtype
    (``optim.py:93-97``): a bf16 table and gradient stay bf16, and the
    update rounds as optax's chain rounds it."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(6, 8)).astype(np.float32)
    jcfg, tcfg = _cfgs(embedding_optimizer="rowwise_adagrad",
                       gradient_clip_norm=0.0, weight_decay=0.0,
                       embedding_learning_rate=0.05)
    jp = {"user_emb": jnp.asarray(table, jnp.bfloat16)}
    jtx = jmake(jcfg.train)
    js = jtx.init(jp)
    tp = {"user_emb": torch.from_numpy(table).to(torch.bfloat16)}
    topt = make_optimizer(tcfg.train)
    ts = topt.init(tp)
    for _ in range(3):
        g = rng.normal(size=table.shape).astype(np.float32)
        upd, js = jtx.update({"user_emb": jnp.asarray(g, jnp.bfloat16)}, js,
                             jp)
        assert upd["user_emb"].dtype == jnp.bfloat16
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(tp, [torch.from_numpy(g).to(torch.bfloat16)], ts)
    assert tp["user_emb"].dtype == torch.bfloat16
    np.testing.assert_allclose(
        tp["user_emb"].to(torch.float32).numpy(),
        np.asarray(jp["user_emb"]).astype(np.float32), rtol=BF16_RTOL,
        atol=0)
