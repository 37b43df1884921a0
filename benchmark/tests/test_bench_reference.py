"""The comparison that decides ``correct``, at sizes a test run holds,
on the CPU (the port's plain kernels), through ``run.run_cell``: the
harness's whole run without the look for a card.

- the port passes against the reference in every cell;
- the control (the reference one precision below the configuration's,
  in the program's place) fails at least one number of every cell;
- the timed path broken underneath makes ``correct`` false: an answer
  altered where it is produced (retrieval); a step that returns its
  state unchanged, half of the batch left out with the mean over the
  rest, and the tables' rows left unmoved while their optimizer state
  moves (training); the sparse update written to the wrong rows.
"""

import copy
import importlib
import json
import os

import pytest
import torch

from benchmark import run, spec

SMALL = {
    "bigvocab-retrieve-b64": {
        "model": {"num_users": 5000, "num_items": 3000},
        # no B5 on the CPU: the plain path serves
        "traffic": {"pool_calls": 8, "check_calls": 4,
                    "b5_launches_per_call": 0}},
    # 100 seen items a user excluded (the deferred seen100 mix's route)
    "bigvocab-retrieve-b64/seen100": {
        "model": {"num_users": 5000, "num_items": 3000},
        "traffic": {"pool_calls": 8, "check_calls": 4, "seen_per_user": 100,
                    "item_zipf": 0.8, "b5_launches_per_call": 0}},
    "ml1m-train-b524288": {
        "model": {"num_users": 300, "num_items": 200},
        "traffic": {"batch_size": 512, "n_interactions": 1000}},
    "bigvocab-train-sparse-b262144": {
        "model": {"num_users": 20000, "num_items": 8000},
        "traffic": {"batch_size": 256, "pool_batches": 4,
                    "active_users": 1000}},
}
TRAIN = ["ml1m-train-b524288", "bigvocab-train-sparse-b262144"]
SEED = 2 ** 31 + 19


def _limits(name):
    with open(os.path.join(spec.HERE, "reference", "limits",
                           name + ".json")) as f:
        return json.load(f)


def _cell(name):
    return spec.load_cell(name.split("/")[0])


def _run(name, seed=SEED):
    return run.run_cell(_cell(name), seed, 0.3, False, "cpu", SMALL[name])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_port_agrees_with_the_reference(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails(name):
    cell = _cell(name)
    mod = importlib.import_module(f"benchmark.drivers.{cell.driver}")
    readings = mod.Driver(cell, SEED, "cpu", SMALL[name]).control()
    limits = _limits(cell.name)
    got = readings["control"]
    assert any(got[k] > limits[k] for k in got if k in limits), got


def test_an_altered_answer_is_not_correct(monkeypatch):
    from ncf_tpu_torch.serving import scorer

    real = scorer.AdvancedNCFScorer.topk_for_users

    def altered(self, *a, **kw):
        s, ids = real(self, *a, **kw)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % self.cfg.num_items
        return s, ids

    monkeypatch.setattr(scorer.AdvancedNCFScorer, "topk_for_users", altered)
    result = _run("bigvocab-retrieve-b64")
    assert not result["correct"], result["checks"]


def _wrap_step(monkeypatch, fault):
    import ncf_tpu_torch.train as train_pkg

    for name in ("make_train_step", "make_sparse_train_step"):
        real = getattr(train_pkg, name)

        def make(*a, _real=real, **kw):
            return fault(_real(*a, **kw))

        monkeypatch.setattr(train_pkg, name, make)


def _unchanged(step):
    def faulty(params, state, gen, batch, negatives=None):
        _, _, gen, met = step(copy.deepcopy(params), copy.deepcopy(state),
                              gen, batch, negatives)
        return params, state, gen, met
    return faulty


def _half_batch(step):
    def faulty(params, state, gen, batch, negatives=None):
        h = batch["item_ids"].shape[0] // 2
        return step(params, state, gen, {k: v[:h] for k, v in batch.items()},
                    negatives)
    return faulty


TABLES = ("user_emb", "item_emb")


def _tables_frozen(step):
    """The step's optimizer state moves, the tables' rows do not."""
    def faulty(params, state, gen, batch, negatives=None):
        kept = {p: params[p].clone() for p in TABLES}
        params, state, gen, met = step(params, state, gen, batch, negatives)
        return dict(params, **kept), state, gen, met
    return faulty


def _rows_shifted(step):
    """Each table's update written one row further on."""
    def faulty(params, state, gen, batch, negatives=None):
        kept = {p: params[p].clone() for p in TABLES}
        params, state, gen, met = step(params, state, gen, batch, negatives)
        moved = {p: kept[p] + (params[p] - kept[p]).roll(1, 0)
                 for p in TABLES}
        return dict(params, **moved), state, gen, met
    return faulty


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _tables_frozen],
                         ids=["state_unchanged", "half_batch",
                              "tables_frozen"])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    _wrap_step(monkeypatch, fault)
    result = _run(name)
    assert not result["correct"], result["checks"]


def test_a_sparse_update_to_the_wrong_rows_is_not_correct(monkeypatch):
    _wrap_step(monkeypatch, _rows_shifted)
    result = _run("bigvocab-train-sparse-b262144")
    assert not result["correct"], result["checks"]
    assert result["checks"]["stray_gap"]["value"] > \
        result["checks"]["stray_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_a_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result = run.run_cell(spec.load_cell(name), SEED, 2.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
