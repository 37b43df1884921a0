"""The ``Trainer`` and the evaluators over a mesh of 2 gloo ranks,
against the port's one process.

- The ``Trainer`` on 2 ranks against the 1-rank ``Trainer`` (the host
  pipeline on both): the loss of every step within rtol 1e-5, the params
  after an epoch within 5e-5 of their largest magnitude, ``validate`` on
  the same params equal (the rank metrics exactly, ``val_loss`` within
  rtol 1e-6), and a mid-epoch resume of its sharded checkpoint on 2
  ranks ending in the bits of the uninterrupted run.
- ``DeviceEvaluator`` and ``FullCatalogEvaluator`` under a ``(1, 2)`` mesh
  (params sharded, lookups through the exchange): every rank equal to
  the single-device evaluator's.
(Sharded checkpoints between the packages and across topologies:
``tests/test_torch_parallel_checkpoint.py``.)
"""

import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu_torch.data import generate_interactions  # noqa: E402
from ncf_tpu_torch.evals.evaluate import DeviceEvaluator, EvalSet  # noqa: E402
from ncf_tpu_torch.evals.full_eval import FullCatalogEvaluator  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ncf_tpu_torch.train.checkpoint import _leaves_with_path  # noqa: E402
from ncf_tpu_torch.train.trainer import Trainer  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

STEP_REL = 5e-5


def _leaf_close(got, want, rel, what, floor=1e-12, ranks=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = max(rel * np.abs(want).max(), floor)
    err = np.abs(got - want)
    at = np.unravel_index(int(err.argmax()), err.shape) if err.size else ()
    assert err.max() <= tol, (
        f"{what}: max |2 ranks - 1| {err.max():.3g} at {at} (values "
        f"{got[at]!r}, {want[at]!r}) > {tol:.3g} = {rel} x the leaf's "
        f"largest, {err.max() / tol:.3g} x the tolerance; {ranks}")


def _losses_close(got, want, rtol, ranks):
    """``assert_allclose(got, want, rtol)`` on every logged step's loss,
    the failing step and its relative error named."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (
        f"{got.size} logged steps against {want.size}; {ranks}")
    ok = np.isclose(got, want, rtol=rtol, atol=0, equal_nan=True)
    i = int(np.argmin(ok))
    assert ok[i], (
        f"step {i + 1}: loss {got[i]!r} against {want[i]!r}, relative "
        f"error {abs(got[i] - want[i]) / abs(want[i]):.3g} > {rtol}; "
        f"{ranks}")


def _run_timed(task, world, io):
    """``workers.run`` with each rank's wall time (for the messages)."""
    t0 = time.perf_counter()
    texts = workers.run(task, world, io, device="cpu")
    took = [line for t in texts for line in t.splitlines()
            if " took " in line]
    return (f"ranks' wall time {time.perf_counter() - t0:.1f} s "
            f"({'; '.join(took)})")


def _flat(tree, prefix):
    """``{prefix.path: array}`` under the checkpoint's leaf names."""
    return {f"{prefix}.{p}": (v.detach().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v))
            for p, v in _leaves_with_path(tree)}


LOG = dict(num_users=200, num_items=64, num_days=30, avg_txns_per_user=8,
           seed=3)


def _trainer_cfg(ckpt_dir, metrics_file):
    cfg = Config()
    m, t = cfg.model, cfg.train
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
    m.compute_dtype, m.dropout, m.fused_tower = "float32", 0.0, "off"
    t.batch_size, t.num_epochs, t.steps_per_dispatch = 64, 1, 1
    t.input_pipeline, t.embedding_scatter = "host", "xla"
    t.log_every_steps = 1
    t.checkpoint_every_dispatches = 5
    t.checkpoint_dir, t.metrics_file = ckpt_dir, metrics_file
    cfg.data.eval_batch_size = 32
    cfg.data.num_eval_negatives = 20
    return cfg


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r.get("kind") == "train"]


def test_trainer_on_two_ranks_matches_one(tmp_path):
    cfg1 = _trainer_cfg(str(tmp_path / "c1"), str(tmp_path / "m1.jsonl"))
    t1 = Trainer(cfg1, generate_interactions(**LOG), device="cpu")
    t1.train_epoch(0)
    val1 = t1.validate(0)

    cfg2 = _trainer_cfg(str(tmp_path / "c2"), str(tmp_path / "m2.jsonl"))
    io = str(tmp_path / "io")
    workers.save_inputs(io, _flat(t1.params, "given"),
                        {"config": cfg2.to_dict(), "interactions": LOG})
    workers.run("trainer", 2, io, device="cpu")
    out, res = workers.load_outputs(io, 0)
    np.testing.assert_allclose(_losses(str(tmp_path / "m2.jsonl")),
                               _losses(str(tmp_path / "m1.jsonl")),
                               rtol=1e-5)
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    for p, one in _leaves_with_path(t1.params):
        _leaf_close(out[f"params.{p}"], one.numpy(), STEP_REL, p)
    # validate on the same params: the ranks are the same numbers
    given = res["validate_given"]
    for k, v in val1.items():
        if k.startswith("val_"):
            np.testing.assert_allclose(given[k], v, rtol=1e-6, err_msg=k)
        else:
            assert given[k] == v, k
    assert res["step"] == t1.global_step

    # a 2-rank mid-epoch resume ends in the uninterrupted run's bits
    mids = sorted(glob.glob(str(tmp_path / "c2" / "ckpt_*")))
    mids = [d for d in mids if json.load(open(os.path.join(
        d, "manifest.json"))).get("extra", {}).get("in_epoch")]
    assert mids
    man = json.load(open(os.path.join(mids[0], "manifest.json")))
    assert any(v["kind"] == "sharded" for v in man["leaves"].values())
    cfg3 = _trainer_cfg(str(tmp_path / "c3"), "")
    io3 = str(tmp_path / "io3")
    workers.save_inputs(io3, {}, {"config": cfg3.to_dict(),
                                  "interactions": LOG,
                                  "resume_dir": mids[0]})
    workers.run("trainer", 2, io3, device="cpu")
    out3, _ = workers.load_outputs(io3, 0)
    for p, _ in _leaves_with_path(t1.params):
        np.testing.assert_array_equal(out3[f"resumed.{p}"],
                                      out[f"params.{p}"], err_msg=p)




SPARSE_LOG = dict(num_users=900, num_items=600, num_days=40,
                  avg_txns_per_user=3, seed=11)


def test_sparse_trainer_on_two_ranks_matches_one(tmp_path):
    """The big-vocabulary regime (``sparse_table_update: on``, rowwise
    Adagrad, the sequence path): the 2-rank ``Trainer`` routes its row
    gradients to the table shards' owners; every step's loss within rtol
    1e-5 of the 1-rank ``Trainer``'s, the tables, accumulators and dense
    params within 5e-5 of their largest magnitude after the epoch, and
    its checkpoint holds the accumulators as shards."""
    def cfg_for(tag):
        cfg = _trainer_cfg(str(tmp_path / f"c{tag}"),
                           str(tmp_path / f"m{tag}.jsonl"))
        t = cfg.train
        t.embedding_optimizer, t.embedding_learning_rate = (
            "rowwise_adagrad", 0.01)
        t.sparse_table_update, t.checkpoint_every_dispatches = "on", 0
        cfg.model.use_sequence, cfg.model.history_len = True, 4
        return cfg

    t1 = Trainer(cfg_for(1), generate_interactions(**SPARSE_LOG),
                 device="cpu")
    assert t1.sparse_tables
    t1.train_epoch(0)
    io = str(tmp_path / "io")
    workers.save_inputs(io, {}, {"config": cfg_for(2).to_dict(),
                                 "interactions": SPARSE_LOG})
    ranks = _run_timed("trainer", 2, io)
    out, res = workers.load_outputs(io, 0)
    _losses_close(_losses(str(tmp_path / "m2.jsonl")),
                  _losses(str(tmp_path / "m1.jsonl")), 1e-5, ranks)
    for p, one in _leaves_with_path(t1.params):
        _leaf_close(out[f"params.{p}"], one.numpy(), STEP_REL, p,
                    ranks=ranks)
    assert res["step"] == t1.global_step, ranks
    ck = tckpt.find_latest(str(tmp_path / "c2"))
    man = json.load(open(os.path.join(ck, "manifest.json")))
    assert man["leaves"]["opt_state.user_acc"]["kind"] == "sharded"
    acc = np.concatenate([np.load(os.path.join(ck, sh["file"])) for sh in
                          man["leaves"]["opt_state.user_acc"]["shards"]])
    _leaf_close(acc, t1.opt_state["user_acc"].numpy(), STEP_REL, "user_acc",
                ranks=ranks)


# ------------------------------------------------------------ evaluators

def test_evaluators_under_a_mesh_equal_one_device(tmp_path):
    inter_kw = dict(num_users=120, num_items=64, num_days=30,
                    avg_txns_per_user=8, seed=5)
    inter = generate_interactions(**inter_kw)
    cfg = Config()
    m = cfg.model
    m.num_users, m.num_items = inter.num_users, inter.num_items
    m.num_departments, m.num_categories = (inter.num_departments,
                                           inter.num_categories)
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
    m.compute_dtype, m.fused_tower = "float32", "off"
    params = tmodel.init(torch.Generator().manual_seed(1), m, device="cpu")
    rng = np.random.default_rng(2)
    U = 37                                   # odd: padded blocks a rank
    users = rng.choice(inter.num_users, U, replace=False).astype(np.int32)
    cands = rng.integers(0, m.num_items, (U, 9)).astype(np.int32)
    temporal = {k: rng.integers(0, hi, U).astype(np.int32)
                for k, hi in (("hour", 24), ("day", 7), ("month", 12),
                              ("day_of_year", 365))}
    es = EvalSet(users, cands, temporal)
    dept, cat = inter.item_dept, inter.item_cat
    want = DeviceEvaluator(tmodel, m, es, batch_size=8, item_dept=dept,
                           item_cat=cat, device="cpu").ranks(params)
    want_full = FullCatalogEvaluator(
        m, inter, users, cands[:, 0], item_dept=dept, item_cat=cat,
        user_block=8, item_block=16, device="cpu").ranks(params)
    io = str(tmp_path / "io")
    arrays = {**_flat(params, "params"), "users": users, "candidates": cands,
              "dept": dept, "cat": cat,
              **{f"t.{k}": v for k, v in temporal.items()}}
    workers.save_inputs(io, arrays, {"config": cfg.to_dict(), "B": 8,
                                     "item_block": 16,
                                     "interactions": inter_kw})
    workers.run("eval", 2, io, device="cpu")
    for r in range(2):
        out, _ = workers.load_outputs(io, r)
        np.testing.assert_array_equal(out["sampled"], want)
        np.testing.assert_array_equal(out["full"], want_full)
