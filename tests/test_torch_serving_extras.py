"""Port parity for the rest of serving: the feature store and processor,
the caches, ``ProductSearch``, the embedding export, the intelligence
payload, ``checkpoint.consolidate`` and the ``score``, ``export``,
``consolidate``, ``demo``, ``datagen`` and ``serve`` subcommands, the
port on the CPU (``device="cpu"``) against ``ncf_tpu`` on the same
inputs (params converted from JAX).

Tolerances: feature values, consolidated files and generated logs equal
exactly; ids equal; f32 scores and intelligence numbers within 1e-5
(numbers the payload rounds to 5 digits may differ by one unit there);
exported embedding values within 2e-6 (both packages round to 6 digits);
numbers the demo prints to 4 digits within one unit of the last digit.
"""

import json
import os
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu import cli as jcli  # noqa: E402
from ncf_tpu.data import Interactions as JInteractions  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgen  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.ops import topk as jtopk  # noqa: E402
from ncf_tpu.serving import ann as jann  # noqa: E402
from ncf_tpu.serving import export as jexport  # noqa: E402
from ncf_tpu.serving import features as jfeatures  # noqa: E402
from ncf_tpu.serving import intelligence as jintel  # noqa: E402
from ncf_tpu.train import checkpoint as jckpt  # noqa: E402
from ncf_tpu.utils.config import ModelConfig as JModelConfig  # noqa: E402
from ncf_tpu_torch import cli  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy  # noqa: E402
from ncf_tpu_torch.data import Interactions, generate_interactions  # noqa: E402
from ncf_tpu_torch.serving import ann, export, features, intelligence  # noqa: E402
from ncf_tpu_torch.serving.cache import FeatureCache, TTLCache  # noqa: E402
from ncf_tpu_torch.serving import cache as cache_mod  # noqa: E402
from ncf_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from ncf_tpu_torch.utils.config import ModelConfig  # noqa: E402
from ncf_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

ATOL = 1e-5 + 1e-12


def _to_port(jparams):
    return params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), "cpu")


def _model_cfg(cls, inter, **kw):
    base = dict(num_users=inter.num_users, num_items=inter.num_items,
                num_departments=inter.num_departments,
                num_categories=inter.num_categories, mf_dim=8, mlp_dim=8,
                temporal_dim=4, mlp_hidden_dims=[16, 8],
                compute_dtype="float32")
    base.update(kw)
    return cls(**base)


# ------------------------------------------------------------ features

LOGS = {
    "retail": dict(num_users=120, num_items=60, num_days=30,
                   avg_txns_per_user=12, seed=3),
    "live_api": dict(num_users=80, num_items=40, num_days=20,
                     avg_txns_per_user=10, seed=5),
}


def _raw_log(pkg):
    """A log without categories, with users of one row and tied times."""
    rng = np.random.default_rng(7)
    n = 400
    users = rng.integers(0, 30, n)
    users[:3] = (100, 101, 102)
    items = rng.integers(0, 25, n)
    ts = 1_700_000_000 + 3600 * rng.integers(0, 200, n)
    amounts = rng.uniform(1, 50, n).astype(np.float32)
    return pkg.from_raw(users, items, ts, amounts)


def _stores(name, history_len=50):
    if name == "raw":
        ji, ti = _raw_log(JInteractions), _raw_log(Interactions)
    else:
        ji, ti = jgen(**LOGS[name]), generate_interactions(**LOGS[name])
    return (jfeatures.FeatureStore(ji, history_len),
            features.FeatureStore(ti, history_len))


ARRAYS = ("user_count", "user_spend", "user_first_ts", "user_last_ts",
          "user_account_age_days", "user_interaction_frequency",
          "user_hourly", "user_daily", "user_cat_counts", "item_purchases",
          "item_revenue", "item_unique_customers", "item_avg_price",
          "item_hourly", "item_daily", "item_popularity", "item_loyalty")


@pytest.mark.parametrize("name,history_len", [("retail", 50),
                                              ("live_api", 50),
                                              ("retail", 3), ("raw", 4)])
def test_feature_store_equals_the_reference(name, history_len):
    js, ts = _stores(name, history_len)
    for a in ARRAYS:
        want, got = getattr(js, a), getattr(ts, a)
        if want is None:
            assert got is None, a
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, a
        np.testing.assert_array_equal(got, want, err_msg=a)
    assert ts._hist == js._hist
    for u in range(ts.inter.num_users):
        assert ts.user_history(u) == js.user_history(u)
        assert ts.top_categories(u) == js.top_categories(u)
    for i in range(0, ts.inter.num_items, 7):
        assert ts.co_purchases(i) == js.co_purchases(i)


@pytest.mark.parametrize("name", ["retail", "raw"])
def test_feature_processor_equals_the_reference(name):
    js, ts = _stores(name)
    jp, tp = jfeatures.FeatureProcessor(js), features.FeatureProcessor(ts)
    for u in range(ts.inter.num_users):
        assert tp.get_features(u) == jp.get_features(u)
        got, want = tp.preprocess_for_model(u), jp.preprocess_for_model(u)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    items = np.arange(ts.inter.num_items)
    scores = np.linspace(1, 0, len(items), dtype=np.float32)
    assert tp.enrich_products(items, scores) == jp.enrich_products(items,
                                                                   scores)
    assert tp.enrich_products([3]) == jp.enrich_products([3])
    for v in ([3.0, 1.0, 2.0], [5.0, 5.0]):
        np.testing.assert_array_equal(tp.normalize_metric(v, -1, 1),
                                      jp.normalize_metric(v, -1, 1))
    named = features.FeatureProcessor(ts, item_names=["a", "b"])
    assert named.enrich_products([1, 5])[1]["name"] == "item_5"


# -------------------------------------------------------------- caches

def test_ttl_expiry_and_bound(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(cache_mod.time, "time", lambda: now[0])
    c = TTLCache(max_items=20)
    c.set("k", "v", ttl_s=10)
    assert c.get("k") == "v"
    now[0] += 11
    assert c.get("k") is None and len(c) == 0
    for i in range(20):
        c.set(f"k{i}", i, ttl_s=100 + i)
    c.set("new", 1, ttl_s=1000)             # full: the 2 nearest expiries go
    assert len(c) == 19 and c.get("k0") is None and c.get("k1") is None
    assert c.get("k2") == 2 and c.get("new") == 1
    c.delete("new")
    assert c.get("new") is None


def test_feature_cache_hit_rate_and_metrics():
    m = MetricsLogger()
    fc = FeatureCache(metrics=m)
    assert fc.get_features("c1") is None
    fc.set_features("c1", {"a": 1})
    assert fc.get_features("c1") == {"a": 1}
    assert fc.hit_rate() == pytest.approx(0.5)
    fc.invalidate("c1")
    assert fc.get_features("c1") is None
    fc.set_embedding("u1", [1.0, 2.0])
    assert fc.get_embedding("u1") == [1.0, 2.0]
    for _ in range(96):
        fc.get_features("c2")
    recs = [r for r in m.recent() if r["kind"] == "cache"]
    assert len(recs) == 1 and recs[0]["hits"] == 2 and recs[0]["misses"] == 98


def test_redis_url_without_the_package_stays_local(monkeypatch):
    monkeypatch.setitem(sys.modules, "redis", None)     # import fails
    fc = FeatureCache(redis_url="redis://localhost:6379/0")
    assert fc._redis is None
    fc.set_features("c", {"x": 1})
    assert fc.get_features("c") == {"x": 1}


class TestFeatureCacheRedisBranch:
    """The redis code path with an in-process fake redis module, the
    cases of the reference's ``tests/test_serving.py``."""

    class FakeRedis:
        def __init__(self):
            self.store, self.fail, self.calls = {}, False, []

        def get(self, key):
            self.calls.append(("get", key))
            if self.fail:
                raise ConnectionError("redis down")
            return self.store.get(key)

        def setex(self, key, ttl, value):
            self.calls.append(("setex", key, ttl))
            if self.fail:
                raise ConnectionError("redis down")
            assert isinstance(ttl, int) and ttl > 0
            self.store[key] = value

        def delete(self, *keys):
            self.calls.append(("delete",) + keys)
            if self.fail:
                raise ConnectionError("redis down")
            for k in keys:
                self.store.pop(k, None)

    def _make(self, monkeypatch):
        fake = self.FakeRedis()
        mod = types.ModuleType("redis")
        mod.from_url = lambda url: fake
        monkeypatch.setitem(sys.modules, "redis", mod)
        cache = FeatureCache(redis_url="redis://localhost:6379/0")
        assert cache._redis is fake
        return cache, fake

    def test_roundtrip_through_redis(self, monkeypatch):
        cache, fake = self._make(monkeypatch)
        assert cache.get_features("c1") is None
        cache.set_features("c1", {"age": 30})
        assert cache.get_features("c1") == {"age": 30}
        assert isinstance(fake.store["features:c1"], bytes)
        cache.set_embedding("c1", [1.0, 2.0])
        assert cache.get_embedding("c1") == [1.0, 2.0]
        assert cache.hit_rate() > 0

    def test_ttls_forwarded(self, monkeypatch):
        cache, fake = self._make(monkeypatch)
        cache.set_features("c1", {})
        cache.set_embedding("c1", [0.0])
        ttls = {c[1]: c[2] for c in fake.calls if c[0] == "setex"}
        assert ttls["features:c1"] == cache.feature_ttl
        assert ttls["embedding:c1"] == cache.embedding_ttl

    def test_invalidate_clears_backend(self, monkeypatch):
        cache, fake = self._make(monkeypatch)
        cache.set_features("c1", {"a": 1})
        cache.invalidate("c1")
        assert "features:c1" not in fake.store
        assert cache.get_features("c1") is None

    def test_outage_falls_back_to_local(self, monkeypatch):
        cache, fake = self._make(monkeypatch)
        fake.fail = True
        cache.set_features("c1", {"a": 1})
        assert cache.get_features("c1") == {"a": 1}
        cache.invalidate("c1")
        assert cache.get_features("c1") is None
        assert cache._redis is fake

    def test_backend_dropped_after_consecutive_failures(self, monkeypatch):
        cache, fake = self._make(monkeypatch)
        fake.fail = True
        for i in range(FeatureCache._MAX_REDIS_FAILURES):
            cache.set_features(f"c{i}", {})
        assert cache._redis is None
        cache2, fake2 = self._make(monkeypatch)
        fake2.fail = True
        for i in range(FeatureCache._MAX_REDIS_FAILURES - 1):
            cache2.set_features(f"c{i}", {})
        fake2.fail = False
        cache2.set_features("ok", {"x": 1})
        assert cache2._redis_failures == 0
        fake2.fail = True
        cache2.set_features("again", {})
        assert cache2._redis is fake2


# ------------------------------------------------------- ProductSearch

def _interpret_topk(queries, items, k, bias=None, impl="auto"):
    """The JAX package's ``topk_scores`` with its Pallas kernels run in
    interpret mode, as its own tests run them on the CPU."""
    kernels = {"pallas": jtopk.topk_scores_pallas,
               "streaming": jtopk.topk_scores_streaming,
               "segmented": jtopk.topk_scores_segmented}
    if impl in kernels:
        return kernels[impl](queries, items, k=min(k, items.shape[0]),
                             bias=bias, interpret=True)
    return jtopk.topk_scores(queries, items, k, bias, impl=impl)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("impl", ["auto", "dense", "xla", "pallas",
                                  "streaming", "segmented"])
def test_product_search_matches_the_reference(monkeypatch, metric, impl):
    monkeypatch.setattr(jann, "topk_scores", _interpret_topk)
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(3000, 16)).astype(np.float32)
    emb[5] = 0.0                                     # a zero row
    ids = [f"p{i}" for i in range(len(emb))]
    q = np.concatenate([emb[[17, 2999]], rng.normal(size=(3, 16))])
    q = q.astype(np.float32)
    want = jann.ProductSearch(emb, ids=ids, metric=metric,
                              impl=impl).find_neighbors(q, 7)
    got = ann.ProductSearch(emb, ids=ids, metric=metric, impl=impl,
                            device="cpu").find_neighbors(q, 7)
    assert [[i for i, _ in row] for row in got] == \
        [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([[v for _, v in row] for row in got],
                               [[v for _, v in row] for row in want],
                               rtol=0, atol=1e-5)
    if metric == "cosine" and impl != "segmented":
        assert got[0][0][0] == "p17"
        assert got[0][0][1] == pytest.approx(1.0, abs=1e-5)


def test_product_search_single_query_refresh_and_stats():
    emb = np.eye(8, dtype=np.float32)
    search = ann.ProductSearch(emb, ids=[f"p{i}" for i in range(8)],
                               device="cpu")
    res = search.find_neighbors(emb[3], num_neighbors=2)
    assert len(res) == 1 and res[0][0] == ("p3", pytest.approx(1.0))
    stats = search.get_index_stats()
    assert stats["num_items"] == 8 and stats["dims"] == 8
    assert stats["queries_served"] == 1 and stats["metric"] == "cosine"
    search.refresh(np.eye(4, dtype=np.float32))
    assert search.get_index_stats()["num_items"] == 4
    assert search.get_index_stats()["queries_served"] == 0
    assert search.find_neighbors(np.eye(4)[2], 1)[0][0][0] == 2
    with pytest.raises(ValueError, match="metric"):
        ann.ProductSearch(emb, metric="l2", device="cpu")


# --------------------------------------------------------------- export

@pytest.fixture(scope="module")
def model():
    inter = jgen(**LOGS["retail"])
    tinter = generate_interactions(**LOGS["retail"])
    jcfg = types.SimpleNamespace(model=_model_cfg(JModelConfig, inter))
    tcfg = types.SimpleNamespace(model=_model_cfg(ModelConfig, inter))
    jcfg.model.name = tcfg.model.name = "advanced_ncf"
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    return inter, tinter, jcfg, tcfg, jparams, _to_port(jparams)


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def _same_embeddings(got_path, want_path):
    got, want = _read_jsonl(got_path), _read_jsonl(want_path)
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["embedding"] for r in got],
                               [r["embedding"] for r in want],
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("which", ["mlp", "mf", "category"])
def test_product_export_matches_the_reference(model, tmp_path, which):
    inter, tinter, jcfg, tcfg, jp, tp = model
    want = jexport.export_product_embeddings(
        jp, jcfg, str(tmp_path / "j.jsonl"), inter.item_dept, inter.item_cat,
        which=which, batch=16)
    got = export.export_product_embeddings(
        tp, tcfg, str(tmp_path / "t" / "t.jsonl"), tinter.item_dept,
        tinter.item_cat, which=which, batch=16, device="cpu")
    _same_embeddings(got, want)
    ids, mat = export.load_embeddings_jsonl(got)
    assert ids == [str(i) for i in range(inter.num_items)]
    np.testing.assert_allclose(np.linalg.norm(mat, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["mlp", "mf"])
def test_user_export_matches_the_reference(model, tmp_path, which):
    inter, _, jcfg, tcfg, jp, tp = model
    ext = [f"u{i}" for i in range(inter.num_users)]
    want = jexport.export_user_embeddings(
        jp, jcfg, str(tmp_path / "j.jsonl"), user_ids=ext, which=which,
        batch=50)
    got = export.export_user_embeddings(
        tp, tcfg, str(tmp_path / "t.jsonl"), user_ids=ext, which=which,
        batch=50, device="cpu")
    _same_embeddings(got, want)


def test_search_over_the_export_equals_search_over_the_params(model,
                                                             tmp_path):
    inter, tinter, _, tcfg, _, tp = model
    path = export.export_product_embeddings(
        tp, tcfg, str(tmp_path / "e.jsonl"), tinter.item_dept,
        tinter.item_cat, device="cpu")
    ids, mat = export.load_embeddings_jsonl(path)
    from ncf_tpu_torch.models import advanced_ncf as tmodel

    raw = tmodel.get_product_embeddings(
        tp, tcfg.model, torch.arange(inter.num_items))["mlp"].numpy()
    q = raw[[5, 17, 40]]
    over_file = ann.ProductSearch(mat, ids=ids, device="cpu")
    over_params = ann.ProductSearch(raw, ids=ids, device="cpu")
    got, want = over_file.find_neighbors(q, 5), over_params.find_neighbors(q, 5)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    np.testing.assert_allclose([[v for _, v in r] for r in got],
                               [[v for _, v in r] for r in want], atol=1e-5)
    assert got[0][0][0] == "5"


def test_interactions_export_equals_the_reference(tmp_path):
    inter, tinter = jgen(**LOGS["live_api"]), generate_interactions(
        **LOGS["live_api"])
    jexport.export_interactions_jsonl(inter, str(tmp_path / "j.jsonl"),
                                      limit=500)
    export.export_interactions_jsonl(tinter, str(tmp_path / "t.jsonl"),
                                     limit=500)
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    np.testing.assert_array_equal(export.l2_normalize(np.zeros((2, 3))),
                                  np.zeros((2, 3)))


# --------------------------------------------------------- intelligence

def _close(got, want, where="$"):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= ATOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("sequence", [False, True])
def test_intelligence_report_matches_the_reference(model, sequence):
    inter, _, _, _, _, _ = model
    kw = dict(use_sequence=True, history_len=6) if sequence else {}
    jcfg = _model_cfg(JModelConfig, inter, **kw)
    tcfg = _model_cfg(ModelConfig, inter, **kw)
    jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tp = _to_port(jp)
    rng = np.random.default_rng(0)
    items = rng.choice(inter.num_items, 10, replace=False).astype(np.int32)
    scores = np.sort(rng.uniform(size=10).astype(np.float32))[::-1]
    history = np.asarray([4, 9, 9, 30, -1, -1], np.int32)
    for sample in (None, np.arange(32, dtype=np.int32)):
        want = jintel.intelligence_report(jp, jcfg, 7, scores, items,
                                          sample_users=sample,
                                          history=history)
        got = intelligence.intelligence_report(tp, tcfg, 7, scores, items,
                                               sample_users=sample,
                                               history=history)
        assert ("history_attention" in got) == sequence
        _close(got, want)
    if sequence:
        hist = np.stack([history, np.asarray([1, -1, -1, -1, -1, -1])])
        w = intelligence.history_attention_weights(tp, tcfg, [7, 8], hist)
        np.testing.assert_allclose(
            w, jintel.history_attention_weights(
                jp, jcfg, jnp.asarray([7, 8]), jnp.asarray(hist)),
            rtol=0, atol=1e-6)
        assert (w[hist < 0] == 0).all()
        np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-6)
    else:
        with pytest.raises(ValueError, match="sequence_attn"):
            intelligence.history_attention_weights(tp, tcfg, [1], [[1]])
    heads = intelligence.attention_head_importance(
        tp, tcfg, np.arange(5), np.tile(items, (5, 1)))
    np.testing.assert_allclose(heads, jintel.attention_head_importance(
        jp, jcfg, jnp.arange(5), jnp.asarray(np.tile(items, (5, 1)))),
        rtol=0, atol=1e-6)


def test_intelligence_host_helpers_match_the_reference():
    for s in (np.asarray([0.9, 0.5, 0.1, 1.0, 0.0]), np.full(3, 0.4),
              np.zeros(0)):
        assert intelligence.confidence_histogram(s) == \
            jintel.confidence_histogram(s)
        if len(s):
            np.testing.assert_array_equal(intelligence.normalized_scores(s),
                                          jintel.normalized_scores(s))
    w = np.asarray([[-3.0], [1.0]], np.float32)
    params = {"final": {"w": torch.from_numpy(w)}}
    assert intelligence.component_importance(params) == \
        jintel.component_importance({"final": {"w": jnp.asarray(w)}})


# ----------------------------------------------------------- consolidate

def _jax_checkpoint(directory):
    rng = np.random.default_rng(0)
    tree = {"params": {"user_emb": jnp.asarray(rng.normal(size=(6, 4)),
                                               jnp.float32),
                       "mlp": [{"w": jnp.asarray(rng.normal(size=(4, 3)),
                                                 jnp.float32)}],
                       "ids": jnp.arange(5, dtype=jnp.int32)},
            "count": 3}
    return jckpt.save(str(directory), tree, step=7, epoch=1,
                      metrics={"hr@10": 0.5}, extra={"in_epoch": True})


def _shard(ckpt_dir, leaf, cuts):
    """Rewrite a dense leaf as shards split along axis 0 at ``cuts``, as
    a multi-host save writes it."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["leaves"][leaf]
    arr = np.load(os.path.join(ckpt_dir, meta["file"]))
    os.remove(os.path.join(ckpt_dir, meta["file"]))
    shards, bounds = [], [0] + cuts + [arr.shape[0]]
    for p, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        fname = f"{leaf}.p{p}s{p}.npy"
        np.save(os.path.join(ckpt_dir, fname), arr[a:b])
        shards.append({"file": fname, "index": [[a, b]] + [
            [0, d] for d in arr.shape[1:]]})
    manifest["leaves"][leaf] = {"kind": "sharded",
                                "global_shape": list(arr.shape),
                                "dtype": str(arr.dtype), "shards": shards}
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _same_dirs(got, want):
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        with open(os.path.join(got, name), "rb") as f:
            g = f.read()
        with open(os.path.join(want, name), "rb") as f:
            assert g == f.read(), name


@pytest.mark.parametrize("sharded", [False, True])
def test_consolidate_matches_the_reference(tmp_path, sharded):
    src = _jax_checkpoint(tmp_path / "ck")
    if sharded:
        _shard(src, "params.user_emb", [2, 5])
        _shard(src, "params.ids", [3])
    want = jckpt.consolidate(src, str(tmp_path / "want"))
    got = ckpt.consolidate(src, str(tmp_path / "got"))
    assert got == str(tmp_path / "got")
    _same_dirs(got, want)
    with open(os.path.join(got, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert all(m["kind"] in ("dense", "scalar") for m in leaves.values())
    assert leaves["count"] == {"kind": "scalar", "value": 3.0}


# ---------------------------------------------------------------- CLI

TINY = [
    "data.synthetic_users=60", "data.synthetic_items=30",
    "data.synthetic_days=20", "data.synthetic_avg_txns_per_user=8",
    "model.mf_dim=8", "model.mlp_dim=8", "model.temporal_dim=4",
    "model.mlp_hidden_dims=[16,8]", "model.compute_dtype=float32",
    "model.num_heads=2", "serving.coalesce_requests=false",
]


@pytest.fixture(scope="module")
def cli_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package for the TINY config."""
    d = tmp_path_factory.mktemp("cli")
    args = jcli.build_parser().parse_args(["score"] + TINY)
    cfg = jcli.load_config(args)
    inter = jcli._load_interactions(cfg)
    cfg.model.num_users, cfg.model.num_items = inter.num_users, inter.num_items
    cfg.model.num_departments = inter.num_departments
    cfg.model.num_categories = inter.num_categories
    params = jmodel.init(jax.random.PRNGKey(4), cfg.model)
    return d, jckpt.save(str(d / "ck"), {"params": params}, step=12)


def _both(argv, capsys):
    """Run ``argv`` through the JAX CLI and the port's (``--device
    cpu``); (port stdout, reference stdout)."""
    jargs = jcli.build_parser().parse_args(argv)
    assert jargs.fn(jargs) == 0
    want = capsys.readouterr().out
    assert cli.main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0
    return capsys.readouterr().out, want


def _csv(path):
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    return rows[0], [r[:3] for r in rows[1:]], [float(r[3]) for r in rows[1:]]


def test_cli_score_matches_the_reference(cli_ckpt, capsys):
    d, ck = cli_ckpt
    out = {}
    for name in ("j", "t"):
        path = str(d / f"{name}.csv")
        argv = ["score", "--checkpoint", ck, "--num-users", "25", "--top-k",
                "7", "--output", path] + TINY
        if name == "j":
            jargs = jcli.build_parser().parse_args(argv)
            assert jargs.fn(jargs) == 0
        else:
            assert cli.main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0
        out[name] = _csv(path)
        assert capsys.readouterr().out == f"wrote {path}\n"
    (gh, gi, gs), (wh, wi, ws) = out["t"], out["j"]
    assert gh == wh and gi == wi and len(gi) == 25 * 7
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5 + 1e-6)


def test_cli_export_matches_the_reference(cli_ckpt, capsys):
    d, ck = cli_ckpt
    paths = {}
    for name in ("j", "t"):
        p, u = str(d / f"{name}_items.jsonl"), str(d / f"{name}_users.jsonl")
        argv = ["export", "--checkpoint", ck, "--output", p, "--users",
                "--users-output", u] + TINY
        if name == "j":
            jargs = jcli.build_parser().parse_args(argv)
            assert jargs.fn(jargs) == 0
        else:
            assert cli.main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0
        assert capsys.readouterr().out == f"wrote {p}\nwrote {u}\n"
        paths[name] = (p, u)
    for got, want in zip(paths["t"], paths["j"]):
        _same_embeddings(got, want)


def test_cli_consolidate_matches_the_reference(cli_ckpt, capsys, tmp_path):
    _, ck = cli_ckpt
    got, want = _both(["consolidate", "--checkpoint", ck, "--output",
                       str(tmp_path / "c")] + TINY, capsys)
    assert got == want == f"consolidated {ck} -> {tmp_path / 'c'}\n"
    ref = jckpt.consolidate(ck, str(tmp_path / "ref"))
    _same_dirs(str(tmp_path / "c"), ref)
    # the configured directory's newest checkpoint, and a missing one
    ov = TINY + [f"train.checkpoint_dir={os.path.dirname(ck)}"]
    assert cli.main(["consolidate", "--device", "cpu"] + ov) == 0
    assert capsys.readouterr().out.startswith(f"consolidated {ck} -> ")
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["consolidate", "--device", "cpu", "train.checkpoint_dir="
                  + str(tmp_path / "none")] + TINY)


_NUM = re.compile(r"-?\d+\.\d+")


def _same_printout(got, want, atol):
    got = re.sub(r"\(\d+\.\d ms inference\)", "(ms)", got)
    want = re.sub(r"\(\d+\.\d ms inference\)", "(ms)", want)
    assert _NUM.sub("#", got) == _NUM.sub("#", want)
    np.testing.assert_allclose([float(x) for x in _NUM.findall(got)],
                               [float(x) for x in _NUM.findall(want)],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("hour", [None, 9])
def test_cli_demo_matches_the_reference(cli_ckpt, capsys, hour):
    _, ck = cli_ckpt
    argv = ["demo", "--checkpoint", ck, "--customer", "11", "--top-k", "4"]
    if hour is not None:
        argv += ["--hour", str(hour)]
    got, want = _both(argv + TINY, capsys)
    assert ("hour-of-day=9" in got) == (hour is not None)
    # printed to 2-4 digits: a last digit may round the other way
    _same_printout(got, want, atol=0.01 + 1e-9)


def test_cli_datagen_matches_the_reference(tmp_path, capsys):
    got, want = _both(["datagen", "--output", str(tmp_path / "x.jsonl")]
                      + TINY, capsys)
    t = (tmp_path / "x.jsonl").read_bytes()
    jargs = jcli.build_parser().parse_args(
        ["datagen", "--output", str(tmp_path / "y.jsonl")] + TINY)
    jargs.fn(jargs)
    assert t == (tmp_path / "y.jsonl").read_bytes() and t
    assert got == want


def test_cli_serve_builds_the_api(cli_ckpt, monkeypatch):
    from ncf_tpu_torch import api

    _, ck = cli_ckpt
    seen = {}

    def fake_serve(a, host, port, background=False):
        seen.update(api=a, host=host, port=port)
        status, body = a.dispatch("POST", "/api/v1/recommendations",
                                  {"customer_id": "3",
                                   "exclude_purchased": True})
        seen["status"], seen["body"] = status, body

    monkeypatch.setattr(api, "serve", fake_serve)
    assert cli.main(["serve", "--device", "cpu", "--checkpoint", ck,
                     "--port", "9123"] + TINY) == 0
    assert seen["host"] == "127.0.0.1" and seen["port"] == 9123
    assert isinstance(seen["api"], api.RecommendationAPI)
    assert seen["api"].processor is not None
    assert seen["api"].server.model_version == "ckpt-12"
    assert seen["status"] == 200 and len(seen["body"]["recommendations"]) == 10


def test_cli_demo_falls_back_to_the_shipped_checkpoint(tmp_path, capsys,
                                                       monkeypatch):
    from ncf_tpu_torch.serving import ModelServer

    shipped = cli.shipped_demo_checkpoint()
    assert shipped is not None and shipped == jcli.shipped_demo_checkpoint()
    loaded, load = [], ModelServer.from_checkpoint.__func__

    def spy(klass, cfg, ckpt_dir=None, **kw):
        server = load(klass, cfg, ckpt_dir, **kw)
        loaded.append((ckpt_dir, server.model_version))
        return server

    monkeypatch.setattr(ModelServer, "from_checkpoint", classmethod(spy))
    assert cli.main(["demo", "--device", "cpu", "--customer", "5",
                     f"train.checkpoint_dir={tmp_path / 'none'}",
                     "serving.coalesce_requests=false"]) == 0
    assert loaded == [(shipped, "ckpt-324")]
    out = capsys.readouterr().out
    assert "Top-5 for customer 5" in out and "Model intelligence:" in out
