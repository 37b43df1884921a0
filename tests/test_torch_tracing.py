"""The port's spans and counters (``utils/profiling.py``), on the CPU.

Under a CPU ``torch.profiler`` a dense training step, a sparse one, the
epoch build and each scorer's call show their spans, each inside its
root (``step``, ``serve.call``).  With the profiler on and off the
outputs are equal bit for bit; with none, no span is entered at all.
The sparse update's row counters read the distinct ids of a known batch
and launch and wait for nothing while they count.
"""

import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ncf_tpu_torch.data import generate_interactions, make_sampling_cdf  # noqa: E402
from ncf_tpu_torch.data.pipeline import DeviceEpochPipeline  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf, get_model  # noqa: E402
from ncf_tpu_torch.ops import launch_counters  # noqa: E402
from ncf_tpu_torch.serving.scorer import (AdvancedNCFScorer,  # noqa: E402
                                          BruteForceScorer)
from ncf_tpu_torch.train import optim, sparse, step  # noqa: E402
from ncf_tpu_torch.utils import profiling  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

B = 64
STEP_SPANS = {"step", "step.inputs", "step.forward", "step.backward",
              "step.optimizer", "step.metrics"}
SERVE_SPANS = {"serve.call", "serve.ids", "serve.bias", "serve.query",
               "serve.topk", "serve.to_host", "serve.finish"}


def _cfg(sparse_update: bool) -> Config:
    """A small AdvancedNCF: 60 x 40 for the dense step, 900 x 600 (the
    sparse regime: entities over 4 B S) for the sparse one."""
    cfg = Config()
    m, t = cfg.model, cfg.train
    m.num_users, m.num_items = (900, 600) if sparse_update else (60, 40)
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims = 4, [16, 8]
    m.compute_dtype = "float32"
    m.num_departments, m.num_categories = 3, 5
    t.batch_size = B
    if sparse_update:
        t.embedding_optimizer = "rowwise_adagrad"
        t.embedding_learning_rate = 0.01
        assert step.sparse_mode_available(cfg)
    return cfg


def _meta(items: int):
    rng = np.random.default_rng(0)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    return dept, cat, make_sampling_cdf(1.0 / rng.zipf(1.3, items))


def _batch(cfg: Config, seed: int = 1):
    rng = np.random.default_rng(seed)
    m = cfg.model
    return {"user_ids": rng.integers(0, m.num_users, B).astype(np.int32),
            "item_ids": rng.integers(0, m.num_items, B).astype(np.int32),
            "hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
            "month": rng.integers(0, 12, B),
            "day_of_year": rng.integers(0, 366, B)}


def _step(sparse_update: bool):
    """(the step, its params, its optimizer state, a batch)."""
    cfg = _cfg(sparse_update)
    dept, cat, cdf = _meta(cfg.model.num_items)
    params = advanced_ncf.init(torch.Generator().manual_seed(0), cfg.model,
                               device="cpu")
    if sparse_update:
        dense_opt = optim.make_optimizer(dataclasses.replace(
            cfg.train, gradient_clip_norm=0.0), 1)
        state = step.init_sparse_opt_state(dense_opt, params)
        fn = step.make_sparse_train_step(
            advanced_ncf, cfg, dense_opt, optim.make_schedule(cfg.train, 1),
            cdf, dept, cat, device="cpu")
    else:
        opt = optim.make_optimizer(cfg.train, 1)
        state = opt.init(params)
        fn = step.make_train_step(advanced_ncf, cfg, opt, cdf, dept, cat,
                                  device="cpu")
    return fn, params, state, _batch(cfg)


def _run_step(sparse_update: bool):
    """Two steps from fresh copies of one state: (params, state,
    metrics) as NumPy."""
    fn, params, state, batch = _step(sparse_update)
    params, state = copy.deepcopy(params), copy.deepcopy(state)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        params, state, gen, metrics = fn(params, state, gen, batch)
    return _numpy((params, state, metrics))


def _scorer(kind: str):
    """(a scorer, a call of it)."""
    cfg = _cfg(False)
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    dept, cat, _ = _meta(m.num_items)
    users = np.arange(0, 48, 3, dtype=np.int32)
    if kind == "brute":
        m.name = "ncf"
        model = get_model("ncf")
        sc = BruteForceScorer(model, model.init(gen, m, device="cpu"), m,
                              chunk=16)
        return lambda: sc.topk_for_users(users, k=5)
    sc = AdvancedNCFScorer(advanced_ncf.init(gen, m, device="cpu"), m,
                           torch.as_tensor(dept), torch.as_tensor(cat))
    exclude = np.random.default_rng(0).integers(
        -1, m.num_items, (len(users), 3)).astype(np.int32)
    temporal = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}
    if kind == "hourly":
        return lambda: sc.topk_for_users_hourly(users, 9, k=5,
                                                exclude=exclude)
    return lambda: sc.topk_for_users(users, k=5, temporal=temporal,
                                     exclude=exclude)


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree


def _assert_equal_bits(a, b, where="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def _profiled(fn):
    """(fn's result, the spans recorded: (name, start, end, thread))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events()
             if e.name.startswith(("step", "serve.", "pipeline."))]
    return out, spans


def _inside(child, parent) -> bool:
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


def _assert_nested(spans, root):
    roots = [s for s in spans if s[0] == root]
    assert roots, spans
    for s in spans:
        if s[0] != root:
            assert any(_inside(s, r) for r in roots), (s, roots)


@pytest.mark.parametrize("sparse_update", [False, True],
                         ids=["dense", "sparse"])
def test_a_training_step_shows_its_spans_nested(sparse_update):
    fn, params, state, batch = _step(sparse_update)
    _, spans = _profiled(
        lambda: fn(params, state, torch.Generator().manual_seed(3), batch))
    names = {s[0] for s in spans}
    want = STEP_SPANS | ({"step.sparse_update"} if sparse_update else set())
    # no process group: the reduction is a no-op and opens no span
    assert names == want, names
    assert sum(s[0] == "step" for s in spans) == 1
    _assert_nested(spans, "step")


@pytest.mark.parametrize("kind", ["advanced", "hourly", "brute"])
def test_a_serving_call_shows_its_spans_nested(kind):
    call = _scorer(kind)
    call()                        # the bias and its caches built
    _, spans = _profiled(call)
    names = {s[0] for s in spans}
    want = SERVE_SPANS - ({"serve.bias", "serve.query"} if kind == "brute"
                          else set())
    assert names == want, names
    assert sum(s[0] == "serve.call" for s in spans) == 1
    _assert_nested(spans, "serve.call")


def test_the_epoch_build_is_a_span():
    inter = generate_interactions(num_users=40, num_items=30, num_days=20,
                                  avg_txns_per_user=5, seed=3)
    pipe = DeviceEpochPipeline(inter, 32, seed=1, device="cpu")
    it = pipe.epoch(0)
    _, spans = _profiled(lambda: next(it))
    assert [s[0] for s in spans] == ["pipeline.epoch"]
    # later batches are views of the built epoch: no second build
    _, spans = _profiled(lambda: next(it))
    assert spans == []


@pytest.mark.parametrize("what", ["dense", "sparse", "advanced", "brute"])
def test_outputs_are_equal_with_the_profiler_on_and_off(what):
    if what in ("dense", "sparse"):
        run = lambda: _run_step(what == "sparse")
    else:
        call = _scorer(what)
        run = lambda: _numpy(list(call()))
    off = run()
    on, spans = _profiled(run)
    assert spans
    _assert_equal_bits(on, off)


def test_with_no_profiler_no_span_is_entered(monkeypatch):
    def entered(*a, **k):
        raise AssertionError("a span was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", entered)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not profiling.recording()
    assert profiling.annotate("a") is profiling.annotate("b")
    counters = launch_counters()
    rows = ("sparse_rows_touched", "sparse_rows_processed")
    before = [counters[k].value for k in rows]
    _run_step(False)
    _run_step(True)
    for kind in ("advanced", "hourly", "brute"):
        _scorer(kind)()
    assert [counters[k].value for k in rows] == before


@pytest.mark.parametrize("ids,num_rows,touched", [
    ([5, 3, 5, 7, 3, 3, 0, 9], 10, 5),
    ([4, 4, 4], 10, 1),
    # the sharded combine's out-of-range padding is no touched row
    ([2, 10, 2, 10, 10, 6], 10, 2),
    ([10, 10], 10, 0),
])
def test_the_row_counters_read_the_distinct_ids(monkeypatch, ids, num_rows,
                                                touched):
    counters = launch_counters()
    c_touched = counters["sparse_rows_touched"]
    c_processed = counters["sparse_rows_processed"]
    t0, p0 = c_touched.value, c_processed.value
    ids = torch.as_tensor(ids)
    grads = torch.ones((len(ids), 2))

    def combine():
        return sparse.combine_duplicate_rows(ids, grads, num_rows)

    def aten_ops():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            combine()
        return [e.name for e in prof.events() if e.name.startswith("aten")]

    def waited(*a, **k):
        raise AssertionError("the count read a tensor while counting")

    count_rows = sparse._count_rows

    def guarded(*args):
        # the count itself reads no tensor (on a card: waits for nothing)
        with monkeypatch.context() as mp:
            for name in ("item", "__int__", "__bool__", "tolist"):
                mp.setattr(torch.Tensor, name, waited)
            count_rows(*args)

    with monkeypatch.context() as mp:
        mp.setattr(sparse, "_count_rows", guarded)
        counted = aten_ops()
    # the same ops as a combine that counts nothing
    with monkeypatch.context() as mp:
        mp.setattr(sparse, "_count_rows", lambda *a: None)
        plain = aten_ops()
    assert counted == plain
    assert c_touched.value - t0 == touched
    assert c_processed.value - p0 == len(ids)
    combine()                     # no profiler: nothing counted
    assert c_touched.value - t0 == touched
    assert c_processed.value - p0 == len(ids)


def test_the_sparse_step_counts_its_rows():
    fn, params, state, batch = _step(True)
    counters = launch_counters()
    t0 = counters["sparse_rows_touched"].value
    p0 = counters["sparse_rows_processed"].value
    negs = np.random.default_rng(0).integers(0, 600, (B, 4))
    with profile(activities=[ProfilerActivity.CPU]):
        fn(params, state, torch.Generator(), batch, negs)
    items = np.concatenate([batch["item_ids"][:, None], negs], 1)
    assert counters["sparse_rows_touched"].value - t0 == (
        len(np.unique(batch["user_ids"])) + len(np.unique(items)))
    assert counters["sparse_rows_processed"].value - p0 == B + items.size


def test_a_written_trace_carries_the_step_spans(tmp_path):
    fn, params, state, batch = _step(False)
    d = str(tmp_path / "prof")
    with profiling.trace(d, device="cpu"):
        fn(params, state, torch.Generator(), batch)
    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert STEP_SPANS <= names


def test_block_until_ready_leaves_cuda_alone_for_cpu_trees(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("CUDA touched for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    profiling.block_until_ready({"tables": [torch.ones(2)],
                                 "dense": (torch.zeros(3),
                                           {"w": torch.ones(1)})})
