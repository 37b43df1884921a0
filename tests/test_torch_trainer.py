"""Port parity for ``train/trainer.py::Trainer``, checkpoint saving and
autotune against ``ncf_tpu`` at a small size (300 users x 64 items,
8-wide tables, tower [16, 8], 2 heads, f32, batch 128).

Tolerances: splits, eval sets, batch counts, histories and checkpointed
params and Adam moments are compared exactly (bit for bit); the sampling
CDF within 1e-6 (torch's cumulative sum need not round like
``jnp.cumsum``); ranking metrics of ``validate`` within 1e-6 (the same
ranks; the scores differ only in the order of f32 sums, with dropout
off); ``val_loss`` within 1% of the reference's, because its negatives
come from another random stream (here the port's own value moves by up
to 0.2% from one validation seed to another).  The JAX
``Trainer`` runs with ``steps_per_dispatch`` 1, so its autotune compiles
nothing.
"""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from ncf_tpu.data.synthetic import generate_interactions as jgenerate  # noqa: E402
from ncf_tpu.train import Trainer as JTrainer  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                   params_from_numpy, params_to_numpy)
from ncf_tpu_torch.data import generate_interactions  # noqa: E402
from ncf_tpu_torch.train import Trainer  # noqa: E402
from ncf_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

LOG = dict(num_users=300, num_items=64, num_days=40, avg_txns_per_user=12,
           seed=9)
METRIC_TOL = 1e-6
CDF_TOL = 1e-6
VAL_LOSS_REL = 0.01
RANKING = ("hr@1", "hr@5", "hr@10", "ndcg@10", "mrr@10", "map@10",
           "mean_rank")


@pytest.fixture(scope="module")
def logs():
    return generate_interactions(**LOG), jgenerate(**LOG)


def _small(cfg, ckpt_dir, **train):
    m, t = cfg.model, cfg.train
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
    m.compute_dtype = "float32"
    cfg.data.num_eval_negatives = 20
    t.batch_size, t.num_epochs = 128, 2
    t.checkpoint_dir = str(ckpt_dir)
    t.steps_per_dispatch, t.keep_checkpoints = 1, 1000
    for k, v in train.items():
        section = cfg.model if k in ("dropout", "use_sequence",
                                     "causal_history", "history_len",
                                     "name") else cfg.train
        if k in ("validation_days", "eval_protocol", "eval_user_sample"):
            section = cfg.data
        setattr(section, k, v)
    return cfg


def _cfgs(ckpt_dir, **train):
    return (_small(JConfig(), ckpt_dir, **train),
            _small(Config(), ckpt_dir, **train))


def _named(tree):
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for p, v in ckpt._leaves_with_path(tree)}


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(got, want, what):
    g, w = _named(got), _named(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def _assert_adam_same(port_state, jax_opt_state, what):
    want = adam_state_from_numpy(_jax_np(jax_opt_state), "cpu")
    assert int(port_state["count"]) == int(want["count"]), what
    _assert_same(port_state["mu"], want["mu"], what + " mu")
    _assert_same(port_state["nu"], want["nu"], what + " nu")


# ------------------------------------------------------------ construction

@pytest.mark.parametrize("case", ["time", "fallback", "sequence"])
def test_splits_eval_set_and_batches_match(tmp_path, logs, case):
    tinter, jinter = logs
    kw = {}
    if case == "fallback":
        kw["validation_days"] = 10_000          # every row in the val split
    if case == "sequence":
        kw.update(use_sequence=True, causal_history=True, history_len=5,
                  eval_user_sample=100)
    jcfg, tcfg = _cfgs(tmp_path, **kw)
    jt, tt = JTrainer(jcfg, jinter), Trainer(tcfg, tinter, device="cpu")
    for name in ("user_ids", "item_ids", "timestamps"):
        for split in ("train_inter", "val_inter"):
            np.testing.assert_array_equal(
                getattr(getattr(tt, split), name),
                getattr(getattr(jt, split), name))
    assert len(tt.val_inter) > 0 and len(tt.train_inter) > 0
    np.testing.assert_array_equal(tt.eval_set.users, jt.eval_set.users)
    np.testing.assert_array_equal(tt.eval_set.candidates,
                                  jt.eval_set.candidates)
    for k, v in jt.eval_set.temporal.items():
        np.testing.assert_array_equal(tt.eval_set.temporal[k], v)
    assert len(tt.train_iter) == len(jt.train_iter)
    assert len(tt.val_iter) == len(jt.val_iter)
    assert len(tt.device_pipeline) == len(jt.device_pipeline)
    assert (tt.device_pipeline.epoch_bytes()
            == jt.device_pipeline.epoch_bytes())
    np.testing.assert_allclose(tt.neg_cdf.numpy(), np.asarray(jt.neg_cdf),
                               rtol=0, atol=CDF_TOL)
    np.testing.assert_array_equal(tt.item_dept, np.asarray(jt.item_dept))
    if case == "sequence":
        np.testing.assert_array_equal(tt.user_history,
                                      np.asarray(jt.user_history))
        np.testing.assert_array_equal(tt.eval_history,
                                      np.asarray(jt.eval_history))
        b = next(iter(tt.device_pipeline.epoch(0)))
        assert b["history"].shape == (128, 5)
    # the step's schedule spans the same number of steps
    assert tcfg.train.steps_per_dispatch == jcfg.train.steps_per_dispatch


def test_pipeline_choice_and_gate(tmp_path, logs):
    tinter, _ = logs
    t = Trainer(_small(Config(), tmp_path, input_pipeline="host"), tinter,
                device="cpu")
    assert t.device_pipeline is None
    t = Trainer(_small(Config(), tmp_path, device_epoch_max_bytes=1),
                tinter, device="cpu")
    assert t.device_pipeline is None               # auto: over the gate
    t = Trainer(_small(Config(), tmp_path, device_epoch_max_bytes=1,
                       input_pipeline="device"), tinter, device="cpu")
    assert t.device_pipeline is not None


def test_unported_modes_raise_at_construction(tmp_path, logs, monkeypatch):
    """The mesh is ported (``tests/test_torch_parallel_*.py``): a
    ``Trainer`` over the one-process ``(1, 1)`` mesh and one under
    ``mesh.enable: on`` build; only orbax and a missing card raise."""
    from ncf_tpu_torch.parallel import make_mesh

    tinter, _ = logs
    t = Trainer(_small(Config(), tmp_path), tinter, mesh=make_mesh(),
                device="cpu")
    assert t.mesh.shape == {"dcn": 1, "ici": 1} and t.device_pipeline is None
    cfg = _small(Config(), tmp_path)
    cfg.mesh.enable = "on"
    mesh = cfg.build_mesh()
    assert mesh is not None and mesh.size == 1
    Trainer(cfg, tinter, mesh=mesh, device="cpu")
    cfg.mesh.enable = "auto"                        # one process: no mesh
    assert cfg.build_mesh() is None
    Trainer(cfg, tinter, device="cpu")
    # the sparse table update is ported (test_torch_sparse.py): it builds
    cfg = _small(Config(), tmp_path, sparse_table_update="on",
                 embedding_optimizer="rowwise_adagrad", batch_size=8)
    assert Trainer(cfg, tinter, device="cpu").sparse_tables
    cfg = _small(Config(), tmp_path, embedding_optimizer="rowwise_adagrad",
                 batch_size=8)                     # auto goes sparse
    assert Trainer(cfg, tinter, device="cpu").sparse_tables
    cfg = _small(Config(), tmp_path, sparse_table_update="on")
    with pytest.raises(ValueError, match="rowwise_adagrad"):
        Trainer(cfg, tinter, device="cpu")
    for be in ("orbax", "orbax_async"):
        with pytest.raises(NotImplementedError, match="orbax"):
            Trainer(_small(Config(), tmp_path, checkpoint_backend=be),
                    tinter, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_small(Config(), tmp_path), tinter)


# -------------------------------------------------------------- validation

@pytest.mark.parametrize("protocol", ["sampled", "full"])
def test_validate_matches_on_carried_params(tmp_path, logs, protocol):
    tinter, jinter = logs
    jcfg, tcfg = _cfgs(tmp_path, dropout=0.0, eval_protocol=protocol)
    jt, tt = JTrainer(jcfg, jinter), Trainer(tcfg, tinter, device="cpu")
    jt.params = _perturbed(jt.params, 0)          # away from the init
    tt.params = params_from_numpy(jt.params, "cpu")
    want, got = jt.validate(0), tt.validate(0)
    for k in RANKING + ("num_eval_users",):
        if k in want:
            assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    if protocol == "full":
        assert got["eval_protocol_full"] == 1.0
    assert abs(got["val_loss"] - want["val_loss"]) <= (
        VAL_LOSS_REL * want["val_loss"]), (got["val_loss"], want["val_loss"])
    # the negatives are fixed per call: validate twice, the same loss
    assert tt.validate(1)["val_loss"] == got["val_loss"]
    recs = [r for r in tt.metrics_logger.recent() if r["kind"] == "val"]
    assert [r["epoch"] for r in recs] == [0, 1]


def _perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(
        size=np.shape(x))).astype(np.asarray(x).dtype), tree)


def _as_trained(jt, steps=7):
    """A JAX ``Trainer`` in the state of one that took ``steps`` steps:
    perturbed params, non-zero moments and counts (no step compiled)."""
    rng = np.random.default_rng(steps)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(steps, np.int32).reshape(x.shape)
        return np.abs(rng.normal(size=x.shape)).astype(x.dtype) * 1e-3

    jt.params = _perturbed(jt.params, steps)
    jt.opt_state = jax.tree.map(fill, jt.opt_state)
    jt.global_step = steps


# -------------------------------------------------- checkpoints both ways

@pytest.mark.parametrize("clip,wd", [(5.0, 1e-5), (0.0, 0.0), (0.0, 1e-3)])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, logs, caplog, clip,
                                            wd):
    tinter, jinter = logs
    jcfg, tcfg = _cfgs(tmp_path, gradient_clip_norm=clip, weight_decay=wd)
    jt = JTrainer(jcfg, jinter)
    _as_trained(jt)
    path = jt.save_checkpoint(0, {"val_loss": 1.0})
    tt = Trainer(tcfg, tinter, device="cpu")
    with caplog.at_level(logging.WARNING, logger="ncf_tpu_torch"):
        assert tt.resume(path)
    assert "no rng key" in caplog.text
    _assert_same(tt.params, _jax_np(jt.params), "params")
    _assert_adam_same(tt.opt_state, jt.opt_state, "adam")
    assert tt.global_step == jt.global_step > 0
    assert tt.start_epoch == 1
    # and the port trains on from there
    tt.train_epoch(1)
    assert tt.global_step == jt.global_step + len(tt.train_iter)
    assert int(tt.opt_state["count"]) == tt.global_step


@pytest.mark.parametrize("clip,wd", [(5.0, 1e-5), (0.0, 1e-3)])
def test_port_checkpoint_resumes_in_jax(tmp_path, logs, caplog, clip, wd):
    tinter, jinter = logs
    jcfg, tcfg = _cfgs(tmp_path, gradient_clip_norm=clip, weight_decay=wd)
    tt = Trainer(tcfg, tinter, device="cpu")
    tt.train_epoch(0)
    path = tt.save_checkpoint(0, {"val_loss": 1.0})
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    a = int(clip > 0) + int(wd > 0)
    assert {f"opt_state.{a}.count", f"opt_state.{a + 1}.count",
            "rng"} <= set(leaves)
    jt = JTrainer(jcfg, jinter)
    with caplog.at_level(logging.WARNING, logger="ncf_tpu"):
        assert jt.resume(path)
    assert "no rng key" in caplog.text
    _assert_same(tt.params, _jax_np(jt.params), "params")
    _assert_adam_same(tt.opt_state, jt.opt_state, "adam")
    assert jt.global_step == tt.global_step > 0 and jt.start_epoch == 1


def _mid_epoch_ckpts(ckpt_dir):
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        mf = os.path.join(ckpt_dir, name, "manifest.json")
        if os.path.isfile(mf):
            with open(mf) as f:
                m = json.load(f)
            if (m.get("extra") or {}).get("in_epoch"):
                out.append((os.path.join(ckpt_dir, name), m))
    return out


@pytest.mark.parametrize("pipeline,spd", [
    ("device", 1), ("device", 3), ("host", 1), ("host", 3),
])
def test_kill_resume_bit_exact(tmp_path, logs, pipeline, spd):
    """An uninterrupted run and one resumed from a mid-epoch checkpoint
    end in the same bits (dropout on: the generator is restored)."""
    tinter, _ = logs
    kw = dict(input_pipeline=pipeline, steps_per_dispatch=spd,
              checkpoint_every_dispatches=5)
    t_a = Trainer(_small(Config(), tmp_path / "a", **kw), tinter,
                  device="cpu")
    t_a.train()
    mids = _mid_epoch_ckpts(str(tmp_path / "a"))
    assert mids, "no mid-epoch checkpoints were written"
    pick, manifest = next(((p, m) for p, m in mids if m["epoch"] > 0),
                          mids[-1])
    assert manifest["extra"]["dispatch"] > 0
    t_b = Trainer(_small(Config(), tmp_path / "a", **kw), tinter,
                  device="cpu")
    assert t_b.resume(pick)
    assert t_b.start_epoch == manifest["epoch"]
    assert t_b._resume_dispatch == manifest["extra"]["dispatch"]
    t_b.train()
    assert t_b.global_step == t_a.global_step
    _assert_same(t_b.params, t_a.params, "params")
    _assert_same(t_b.opt_state, t_a.opt_state, "adam")
    assert torch.equal(t_b.rng.get_state(), t_a.rng.get_state())


def test_resume_latest_restores_the_generator(tmp_path, logs):
    tinter, _ = logs
    t = Trainer(_small(Config(), tmp_path), tinter, device="cpu")
    t.train()
    t2 = Trainer(_small(Config(), tmp_path), tinter, device="cpu")
    assert t2.resume()
    assert t2.start_epoch == 2 and t2._resume_dispatch == 0
    assert torch.equal(t2.rng.get_state(), t.rng.get_state())
    assert not Trainer(_small(Config(), tmp_path / "none"), tinter,
                       device="cpu").resume()


def test_midepoch_gc_spares_epoch_boundary_ckpts(tmp_path, logs):
    tinter, _ = logs
    cfg = _small(Config(), tmp_path / "gc", keep_checkpoints=2)
    t = Trainer(cfg, tinter, device="cpu")
    boundary = t.save_checkpoint(0, {"val_loss": 1.0})
    for d in range(1, 6):
        t.global_step += 1
        t.save_checkpoint(1, {"mid_epoch": 1.0},
                          extra={"dispatch": d, "in_epoch": True})
    assert os.path.isdir(boundary)
    assert len(_mid_epoch_ckpts(str(tmp_path / "gc"))) <= 2


def _state_tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=gen),
                       "mlp": [{"b": torch.randn(3, generator=gen)}]},
            "opt_state": {"2": {"count": torch.tensor(7, dtype=torch.int32)}},
            "rng": gen.get_state(), "lr": 0.5}


def test_save_restore_discovery_and_gc(tmp_path):
    d = str(tmp_path)
    state = _state_tree()
    assert ckpt.find_latest(d) is None
    c1 = ckpt.save(d, state, step=5, epoch=1, metrics={"val_loss": 0.5},
                   config={"x": 1})
    zeros = {"params": {"w": torch.zeros(4, 3), "mlp": [{"b": torch.zeros(3)}]},
             "opt_state": {"2": {"count": torch.tensor(0, dtype=torch.int32)}},
             "rng": torch.zeros_like(state["rng"]), "lr": 0.0}
    got, manifest = ckpt.restore(c1, zeros, device="cpu")
    assert manifest["step"] == 5 and manifest["epoch"] == 1
    assert manifest["format_version"] == 1 and manifest["config"] == {"x": 1}
    assert manifest["leaves"]["lr"] == {"kind": "scalar", "value": 0.5}
    _assert_same(got, state, "roundtrip")
    bad = dict(zeros, params={"w": torch.zeros(3, 3),
                              "mlp": [{"b": torch.zeros(3)}]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(c1, bad, device="cpu")
    with pytest.raises(KeyError):
        ckpt.restore(c1, dict(zeros, extra_leaf=torch.zeros(1)), device="cpu")
    with pytest.raises(NotImplementedError):
        ckpt.save(d, state, step=6, backend="orbax")
    cs = [c1] + [ckpt.save(d, state, step=s) for s in (9, 17, 30)]
    assert ckpt.find_latest(d) == cs[-1]
    ckpt.mark_best(d, cs[0])
    ckpt.mark_best(d, cs[1])                      # replaced atomically
    assert ckpt.find_best(d) == os.path.join(d, os.path.basename(cs[1]))
    removed = ckpt.garbage_collect(d, keep=1)
    assert sorted(removed) == [os.path.basename(cs[0]),
                               os.path.basename(cs[2])]
    assert ckpt.garbage_collect(d, keep=1, in_epoch_only=True) == []
    ckpt.wait_for_pending()


def test_named_opt_state_follows_the_optax_chain():
    state = {"count": 3, "mu": {"w": 1}, "nu": {"w": 2}}
    for clip, wd, a in ((5.0, 1e-5, 2), (5.0, 0.0, 1), (0.0, 1e-5, 1),
                        (0.0, 0.0, 0)):
        named = ckpt.named_opt_state(state, clip, wd)
        assert set(named) == {str(a), str(a + 1)}
        assert named[str(a + 1)] == {"count": 3}
        assert ckpt.opt_state_from_named(named) == state


# ---------------------------------------------- the loop: stopping, failure

def _scripted(trainer, scores, metric):
    """Replace the epoch and validation with a script of ``metric``."""
    seq = iter(scores)

    def train_epoch(epoch):
        trainer.global_step += 1
        return {"epoch_seconds": 0.0, "examples_per_s": 0.0}

    def validate(epoch):
        v = next(seq)
        out = {"val_loss": 1.0, "hr@10": 0.0, "ndcg@10": 0.0}
        out[metric] = v
        return out

    trainer.train_epoch, trainer.validate = train_epoch, validate


@pytest.mark.parametrize("metric,scores,stop,best", [
    ("val_loss", [1.0, 0.8, 0.9, 0.95, 0.7], 3, 1),
    ("hr@10", [0.1, 0.3, 0.2, 0.25, 0.9], 3, 1),
    ("hr@10", [0.1, 0.2, 0.3, 0.4, 0.5], 4, 4),
])
def test_early_stopping_matches(tmp_path, logs, metric, scores, stop, best):
    tinter, jinter = logs
    results = []
    for cls, cfg, inter in ((Trainer, Config(), tinter),
                            (JTrainer, JConfig(), jinter)):
        d = tmp_path / cls.__module__.split(".")[0]
        cfg = _small(cfg, d, num_epochs=5, early_stopping_patience=2,
                     early_stopping_metric=metric)
        t = cls(cfg, inter, device="cpu") if cls is Trainer else cls(
            cfg, inter)
        _scripted(t, scores, metric)
        out = t.train()
        with open(os.path.join(ckpt.find_best(str(d)),
                               "manifest.json")) as f:
            best_epoch = json.load(f)["epoch"]
        results.append((out["epoch"], out[metric], t.global_step,
                        best_epoch))
    assert results[0] == results[1]
    assert results[0][0] == best and results[0][2] == stop + 1


def test_emergency_checkpoint_on_failure(tmp_path, logs):
    tinter, _ = logs
    t = Trainer(_small(Config(), tmp_path), tinter, device="cpu")

    def boom(epoch):
        t.global_step += 3
        raise RuntimeError("injected")

    t.train_epoch = boom
    with pytest.raises(RuntimeError, match="injected"):
        t.train()
    latest = ckpt.find_latest(str(tmp_path))
    with open(os.path.join(latest, "manifest.json")) as f:
        m = json.load(f)
    assert m["epoch"] == -1 and m["metrics"] == {"emergency": 1.0}
    assert m["step"] == 3

    def interrupt(epoch):
        t.global_step += 1
        raise KeyboardInterrupt

    t.train_epoch = interrupt
    with pytest.raises(KeyboardInterrupt):
        t.train()
    assert ckpt.find_latest(str(tmp_path)) == latest   # nothing written


def test_trainer_pushes_artifacts(tmp_path, logs):
    tinter, _ = logs
    cfg = _small(Config(), tmp_path / "ck", num_epochs=1, log_every_steps=1,
                 metrics_file=str(tmp_path / "m.jsonl"),
                 artifact_store=str(tmp_path / "store"), job_name="smoke")
    Trainer(cfg, tinter, device="cpu").train()
    root = tmp_path / "store" / "smoke"
    assert (root / "manifest.json").exists()
    lines = (root / "metrics.jsonl").read_text().splitlines()
    assert {json.loads(x)["kind"] for x in lines} == {"train", "val"}
    assert any(p.name.startswith("ckpt_")
               for p in (root / "checkpoint").iterdir())


def test_autotune_leaves_the_state_untouched(tmp_path, logs):
    tinter, _ = logs
    ref = Trainer(_small(Config(), tmp_path / "r"), tinter, device="cpu")
    cfg = _small(Config(), tmp_path / "a", steps_per_dispatch=0)
    t = Trainer(cfg, tinter, device="cpu")
    assert cfg.train.steps_per_dispatch in (1, 8, 16, 32)
    assert t.global_step == 0
    _assert_same(t.params, ref.params, "params")
    _assert_same(t.opt_state, ref.opt_state, "adam")
    assert torch.equal(t.rng.get_state(), ref.rng.get_state())
    m = t.train_epoch(0)
    assert t.global_step == len(t.train_iter)
    assert np.isfinite(m["epoch_seconds"])


# ------------------------------------------------- NCF / NeuMF and logging

@pytest.mark.parametrize("name", ["ncf", "neumf"])
def test_ncf_models_train_through_the_trainer(tmp_path, logs, name):
    """The loss falls over three epochs, and validation under
    ``eval_protocol: full`` takes ``full_ranks_naive``; its metrics equal
    the reference ``Trainer``'s on the carried params."""
    tinter, jinter = logs
    jcfg, tcfg = _cfgs(tmp_path, name=name, num_epochs=3, log_every_steps=1,
                       eval_protocol="full", dropout=0.0,
                       learning_rate=3e-3)
    tt = Trainer(tcfg, tinter, device="cpu")
    tt.train()
    losses = [r["loss"] for r in tt.metrics_logger.recent(1000)
              if r["kind"] == "train"]
    steps = len(tt.train_iter)
    assert len(losses) == 3 * steps
    assert np.mean(losses[-steps:]) < np.mean(losses[:steps])
    val = [r for r in tt.metrics_logger.recent(1000) if r["kind"] == "val"]
    assert len(val) == 3 and val[-1]["eval_protocol_full"] == 1.0
    jt = JTrainer(jcfg, jinter)
    jt.params = jax.tree.map(np.asarray, params_to_numpy(tt.params))
    want, got = jt.validate(0), tt.validate(0)
    for k in RANKING:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
