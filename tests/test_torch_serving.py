"""Port parity for serving: ``AdvancedNCFScorer`` and ``ModelServer`` on
the demo checkpoint, the port on the CPU (``device="cpu"``) against
``ncf_tpu``.  366 items take the dense path in both packages.

Tolerances: ids equal; scores (sigmoid probabilities) within 1e-5 at
float32 compute, where the two differ only in summation order.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu.serving import ModelServer as JServer  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.serving import ModelServer, scorer as tscorer  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "demo", "checkpoint")
TEMPORAL = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}


@pytest.fixture(scope="module")
def servers():
    rng = np.random.default_rng(0)
    jcfg, tcfg = JConfig(), Config()
    jcfg.model.compute_dtype = tcfg.model.compute_dtype = "float32"
    dept = rng.integers(0, 9, jcfg.model.num_items).astype(np.int32)
    cat = rng.integers(0, 30, jcfg.model.num_items).astype(np.int32)
    js = JServer.from_checkpoint(jcfg, DEMO, item_dept=dept, item_cat=cat)
    ts = ModelServer.from_checkpoint(tcfg, DEMO, device="cpu",
                                     item_dept=dept, item_cat=cat)
    yield js, ts
    js.close()
    ts.close()


def _same(got, want, atol=1e-5):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0,
                               atol=atol)


def test_from_checkpoint(servers):
    js, ts = servers
    assert ts.model_version == js.model_version == "ckpt-324"
    assert ts.device.type == "cpu"
    assert ts.params["user_emb"].shape == (8031, 128)
    assert ts.params["mlp"][2]["norm"]["scale"].shape == (64,)


@pytest.mark.parametrize("temporal", (None, TEMPORAL))
def test_topk_for_users(servers, temporal):
    js, ts = servers
    users = np.arange(0, 8031, 997)
    _same(ts.scorer.topk_for_users(users, k=10, temporal=temporal),
          js.scorer.topk_for_users(users, k=10, temporal=temporal))


def test_topk_for_users_with_exclusion(servers):
    js, ts = servers
    users = np.asarray([4, 50, 700])
    exclude = np.asarray([[1, 2, 3, -1], [10, 20, 30, 40], [-1, -1, 5, 6]])
    _, base = ts.scorer.topk_for_users(users, k=10)
    exclude[0, :3] = base[0, :3]
    got = ts.scorer.topk_for_users(users, k=10, exclude=exclude)
    _same(got, js.scorer.topk_for_users(users, k=10, exclude=exclude))
    assert not set(base[0, :3]) & set(got[1][0])


@pytest.mark.parametrize("hour", (0, 8, 23))
def test_topk_for_users_hourly(servers, hour):
    js, ts = servers
    users = np.asarray([1, 2, 3000])
    _same(ts.scorer.topk_for_users_hourly(users, hour=hour, k=7),
          js.scorer.topk_for_users_hourly(users, hour=hour, k=7))


@pytest.mark.parametrize("temporal", (None, TEMPORAL))
def test_score_pairs_and_predictions(servers, temporal):
    js, ts = servers
    users, items = np.asarray([1, 2, 3, 8000]), np.asarray([10, 20, 30, 365])
    np.testing.assert_allclose(
        ts.scorer.score_pairs(users, items, temporal),
        js.scorer.score_pairs(users, items, temporal), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        ts.get_predictions(42, items, temporal),
        js.get_predictions(42, items, temporal), rtol=0, atol=1e-5)


def test_recommend_and_batch(servers):
    js, ts = servers
    got, want = ts.recommend(11, k=5), js.recommend(11, k=5)
    _same(got[:2], want[:2])
    got = ts.recommend(11, k=5, temporal=TEMPORAL, exclude_items=[1, 2])
    want = js.recommend(11, k=5, temporal=TEMPORAL, exclude_items=[1, 2])
    _same(got[:2], want[:2])
    _same(ts.recommend_hourly(11, hour=7, k=5)[:2],
          js.recommend_hourly(11, hour=7, k=5)[:2])
    users = np.arange(64) * 100
    _same(ts.recommend_batch(users, k=10, temporal=TEMPORAL)[:2],
          js.recommend_batch(users, k=10, temporal=TEMPORAL)[:2])


def test_embeddings(servers):
    js, ts = servers
    for name in ("get_user_embedding", "get_product_embedding"):
        got = getattr(ts, name)([0, 5, 300])
        want = getattr(js, name)([0, 5, 300])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


def test_concurrent_requests_through_the_coalescer(servers):
    js, ts = servers
    users = list(range(100, 1700, 100))
    results, errors = {}, []
    barrier = threading.Barrier(len(users))

    def call(u):
        try:
            barrier.wait(timeout=30)
            results[u] = ts.recommend(u, k=10)[:2]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(u,)) for u in users]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    want_s, want_i = js.scorer.topk_for_users(np.asarray(users), k=10)
    for r, u in enumerate(users):
        _same(results[u], (want_s[r], want_i[r]))
    c = ts._coalescer
    assert c.direct_calls + c.batched_requests >= len(users)


def test_item_bias_chunking_changes_nothing(servers, monkeypatch):
    _, ts = servers
    full = ts.scorer._mlp_pred_all_items(TEMPORAL)
    monkeypatch.setattr(tscorer, "_BIAS_CHUNK_ROWS", 100)
    torch.testing.assert_close(ts.scorer._mlp_pred_all_items(TEMPORAL), full,
                               rtol=0, atol=1e-6)


def test_reload_and_presets(servers):
    js, ts = servers
    ts.reload(DEMO)
    _same(ts.scorer.topk_for_users([3], k=5), js.scorer.topk_for_users([3], k=5))
    cfg = Config()
    cfg.serving.coalesce_requests = False
    # the int8 presets serve now; a small catalog takes the exact dense
    # path under every preset, as in the reference
    want = None
    for preset in ("exact", "int8", "int8-fast"):
        cfg.serving.retrieval = preset
        server = ModelServer(cfg, params=ts.params, device="cpu")
        try:
            got = server.scorer.topk_for_users([3, 9], k=5)
            want = got if want is None else want
            _same(got, want)
        finally:
            server.close()
    # sequence models serve now, through the two-stage scorer
    cfg.serving.retrieval = "fast"
    cfg.model.use_sequence = True
    cfg.model.num_users, cfg.model.num_items = 40, 30
    hist = np.full((40, 5), -1, np.int32)
    hist[:, :3] = np.arange(120).reshape(40, 3) % 30
    seq = ModelServer(cfg, device="cpu", user_history=hist)
    try:
        assert isinstance(seq.scorer, tscorer.SequenceRescoreScorer)
        scores, ids, _ = seq.recommend(3, k=5)
        assert ids.shape == (5,) and np.isfinite(scores).all()
    finally:
        seq.close()


def test_cache_eviction_under_concurrent_contexts(servers):
    # the coalescer's dispatchers share the scorer's caches: many threads
    # asking for more temporal contexts than the cache holds must neither
    # fail nor mix contexts up
    import sys

    from ncf_tpu_torch.serving.scorer import AdvancedNCFScorer

    _, ts = servers
    scorer = AdvancedNCFScorer(ts.params, ts.cfg.model, ts.item_dept,
                               ts.item_cat, bias_cache_size=2)
    contexts = [{"hour": h, "day": 1, "month": 2, "day_of_year": 40}
                for h in range(6)]
    want = {h: ts.scorer.topk_for_users([7], k=5, temporal=c)[1]
            for h, c in enumerate(contexts)}
    errors, got = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(i):
            try:
                for j in range(6):
                    h = (i + j) % 6
                    got.append((h, scorer.topk_for_users(
                        [7], k=5, temporal=contexts[h])[1]))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 24 * 6
    for h, ids in got:
        np.testing.assert_array_equal(ids, want[h])
    assert len(scorer._bias_cache) <= 2
