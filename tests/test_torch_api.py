"""Port parity for the HTTP API: ``ncf_tpu_torch.api.RecommendationAPI``
on the CPU (``device="cpu"``) against ``ncf_tpu.api`` with the same
params (converted from JAX), the same log and the same requests.

The shape is ``tests/test_api.py``'s ``live_api``: 80 users x 40 items,
mf/mlp 8, temporal 4, tower [16, 8], f32.  Tolerances: equal statuses,
equal ids and JSON; f32 scores and every other float within 1e-5 (values
the API rounds to 5 digits may differ by one unit there).  The timing
fields (``inference_time_ms``, ``total_time_ms``, ``uptime_s`` and the
latency aggregates of ``/metrics``) are left out.  For a body that fails
validation only ``error`` is compared: ``detail`` is the validator's own
text (pydantic's in the reference).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from ncf_tpu import api as japi  # noqa: E402
from ncf_tpu.data.synthetic import generate_interactions as jgen  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.serving import FeatureProcessor as JProc  # noqa: E402
from ncf_tpu.serving import FeatureStore as JStore  # noqa: E402
from ncf_tpu.serving import ModelServer as JServer  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch import api  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy  # noqa: E402
from ncf_tpu_torch.data import generate_interactions  # noqa: E402
from ncf_tpu_torch.serving import (FeatureProcessor, FeatureStore,  # noqa: E402
                                   ModelServer)
from ncf_tpu_torch.serving import dtos  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

TIMING = {"inference_time_ms", "total_time_ms", "uptime_s",
          "latency_ms_p50", "latency_ms_p99", "latency_ms_mean"}
ATOL = 1e-5 + 1e-12


def _cfg(cls, inter, ckpt_dir):
    cfg = cls()
    m = cfg.model
    m.num_users, m.num_items = inter.num_users, inter.num_items
    m.num_departments = inter.num_departments
    m.num_categories = inter.num_categories
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim = 4
    m.mlp_hidden_dims = [16, 8]
    m.compute_dtype = "float32"
    cfg.train.checkpoint_dir = str(ckpt_dir)    # empty: refresh rebuilds
    return cfg


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("no_ckpt")
    kw = dict(num_users=80, num_items=40, num_days=20, avg_txns_per_user=10,
              seed=5)
    jinter, tinter = jgen(**kw), generate_interactions(**kw)
    jcfg, tcfg = _cfg(JConfig, jinter, ckpt_dir), _cfg(Config, tinter,
                                                       ckpt_dir)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), "cpu")
    js = JServer(jcfg, jparams, jinter.item_dept, jinter.item_cat)
    ts = ModelServer(tcfg, params=tparams, item_dept=tinter.item_dept,
                     item_cat=tinter.item_cat, device="cpu")
    ja = japi.RecommendationAPI(js, JProc(JStore(jinter)))
    ta = api.RecommendationAPI(ts, FeatureProcessor(FeatureStore(tinter)))
    yield ja, ta
    js.close()
    ts.close()


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _assert_json_close(got, want, where="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_json_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (where, got, want)
        assert abs(got - want) <= ATOL, (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


# (method, path, body): every route, contexts, exclusion, the batch, the
# hour-of-day intelligence, refresh, and the 404s
REQUESTS = [
    ("GET", "/health", None),
    ("POST", "/api/v1/recommendations",
     {"customer_id": "7", "num_recommendations": 5}),
    ("POST", "/api/v1/recommendations",
     {"customer_id": "3", "num_recommendations": 4,
      "context": {"hour": 8, "day": 1, "month": 3, "day_of_year": 70},
      "exclude_purchased": True}),
    ("POST", "/api/v1/recommendations",
     {"customer_id": "12", "context": {"hour": 9}}),
    ("POST", "/api/v1/recommendations/batch",
     {"customer_ids": ["1", "2", "3"], "num_recommendations": 3}),
    ("POST", "/api/v1/recommendations/batch",
     {"customer_ids": [str(i) for i in range(0, 80, 5)],
      "context": {"hour": 20, "day": 6}}),
    ("POST", "/api/v1/intelligence",
     {"customer_id": "3", "num_recommendations": 5}),
    ("POST", "/api/v1/intelligence",
     {"customer_id": "3", "num_recommendations": 5, "hour": 9}),
    ("POST", "/api/v1/intelligence", {"customer_id": "50", "hour": 17}),
    ("POST", "/api/v1/index/refresh", {}),
    ("POST", "/api/v1/index/refresh", None),
    ("GET", "/nope", None),
    ("POST", "/api/v1/nope", {}),
    ("POST", "/api/v1/recommendations", {"customer_id": "99999"}),
    ("POST", "/api/v1/recommendations", {"customer_id": "abc"}),
    ("POST", "/api/v1/recommendations/batch", {"customer_ids": ["1", "80"]}),
    ("GET", "/metrics", None),
]


def test_dispatch_matches_the_reference(apis):
    ja, ta = apis
    for method, path, body in REQUESTS:
        ws, wp = ja.dispatch(method, path, body)
        gs, gp = ta.dispatch(method, path, body)
        assert gs == ws, (method, path, body, gp)
        if ws == 404 and "detail" in wp:     # KeyError text matches too
            assert gp["detail"] == wp["detail"]
        _assert_json_close(_strip(gp), _strip(wp), f"{method} {path}")


R, B, INTEL = ("/api/v1/recommendations", "/api/v1/recommendations/batch",
               "/api/v1/intelligence")
# bounds, missing fields, pydantic's lax coercions, wrong shapes
BODIES = [
    (R, {}), (R, {"num_recommendations": 5}), (R, {"customer_id": 7}),
    (R, {"customer_id": None}), (R, {"customer_id": ["7"]}),
    (R, {"customer_id": "7", "num_recommendations": "5"}),
    (R, {"customer_id": "7", "num_recommendations": " 5 "}),
    (R, {"customer_id": "7", "num_recommendations": "5.0"}),
    (R, {"customer_id": "7", "num_recommendations": "1_0"}),
    (R, {"customer_id": "7", "num_recommendations": "1e1"}),
    (R, {"customer_id": "7", "num_recommendations": "5.5"}),
    (R, {"customer_id": "7", "num_recommendations": "0x5"}),
    (R, {"customer_id": "7", "num_recommendations": 5.0}),
    (R, {"customer_id": "7", "num_recommendations": 5.5}),
    (R, {"customer_id": "7", "num_recommendations": True}),
    (R, {"customer_id": "7", "num_recommendations": None}),
    (R, {"customer_id": "7", "num_recommendations": 0}),
    (R, {"customer_id": "7", "num_recommendations": 1}),
    (R, {"customer_id": "7", "num_recommendations": 100}),
    (R, {"customer_id": "7", "num_recommendations": 101}),
    (R, {"customer_id": "7", "num_recommendations": -3}),
    (R, {"customer_id": "7", "num_recommendations": 1e300}),
    (R, {"customer_id": "7", "num_recommendations": [5]}),
    (R, {"customer_id": "7", "exclude_purchased": "true"}),
    (R, {"customer_id": "7", "exclude_purchased": "Yes"}),
    (R, {"customer_id": "7", "exclude_purchased": "off"}),
    (R, {"customer_id": "7", "exclude_purchased": " true"}),
    (R, {"customer_id": "7", "exclude_purchased": "maybe"}),
    (R, {"customer_id": "7", "exclude_purchased": 1}),
    (R, {"customer_id": "7", "exclude_purchased": 2}),
    (R, {"customer_id": "7", "exclude_purchased": 0.0}),
    (R, {"customer_id": "7", "exclude_purchased": None}),
    (R, {"customer_id": "7", "context": {"hour": "9"}}),
    (R, {"customer_id": "7", "context": {"hour": 9.0, "day": True}}),
    (R, {"customer_id": "7", "context": {"hour": 9.5}}),
    (R, {"customer_id": "7", "context": {"hour": None}}),
    (R, {"customer_id": "7", "context": [9]}),
    (R, {"customer_id": "7", "context": None}),
    (R, {"customer_id": "7", "context": {}}),
    (R, {"customer_id": "7", "unknown": 1}),
    (R, {"customer_id": " 7 "}), (R, {"customer_id": "7.0"}),
    (R, {"customer_id": "-1"}), (R, {"customer_id": "80"}),
    (R, []), (R, ["7"]), (R, "7"), (R, 7),
    (B, {}), (B, {"customer_ids": "1"}), (B, {"customer_ids": ["1", 2]}),
    (B, {"customer_ids": None}), (B, {"customer_ids": []}),
    (B, {"customer_ids": [str(i) for i in range(101)]}),
    (B, {"customer_ids": [str(i % 80) for i in range(100)]}),
    (B, {"customer_ids": ["1"], "num_recommendations": 0}),
    (B, {"customer_ids": ["1"], "context": {"hour": "x"}}),
    (INTEL, {"customer_id": "3", "hour": 24}),
    (INTEL, {"customer_id": "3", "hour": -1}),
    (INTEL, {"customer_id": "3", "hour": 23}),
    (INTEL, {"customer_id": "3", "hour": "9"}),
    (INTEL, {"customer_id": "3", "hour": 9.0}),
    (INTEL, {"customer_id": "3", "hour": 9.5}),
    (INTEL, {"customer_id": "3", "hour": None}),
    (INTEL, {"customer_id": "3", "hour": 99}),
    (INTEL, {"customer_id": "3", "num_recommendations": 101}),
    (INTEL, {"hour": 9}),
]


@pytest.mark.parametrize("path,body", BODIES,
                         ids=[f"{i}" for i in range(len(BODIES))])
def test_validation_table_matches_the_reference(apis, path, body):
    ja, ta = apis
    ws, wp = ja.dispatch("POST", path, body)
    gs, gp = ta.dispatch("POST", path, body)
    assert gs == ws, (body, gp, wp)
    assert gp.get("error") == wp.get("error")
    if ws == 200:
        _assert_json_close(_strip(gp), _strip(wp))


def test_the_table_covers_both_outcomes(apis):
    ja, _ = apis
    statuses = {ja.dispatch("POST", p, b)[0] for p, b in BODIES}
    assert {200, 404, 422} <= statuses


def test_dtos_dump_like_pydantic():
    from ncf_tpu.serving import dtos as jdtos

    rec = dict(product_id="4", score=0.5, rank=1,
               metadata=dict(name="a", department=None, category="c",
                             avg_price=2.0, popularity_score=None),
               explanation=None)
    resp = dict(customer_id="1", recommendations=[rec, dict(
        product_id="5", score=0.25, rank=2)], model_version="v",
        inference_time_ms=1.5)
    want = jdtos.RecommendationResponse.model_validate(resp).model_dump()
    got = dtos.RecommendationResponse(
        customer_id="1",
        recommendations=[
            dtos.ProductRecommendation(
                product_id="4", score=0.5, rank=1,
                metadata=dtos.ProductMetadata(name="a", category="c",
                                              avg_price=2.0)),
            dtos.ProductRecommendation(product_id="5", score=0.25, rank=2)],
        model_version="v", inference_time_ms=1.5).to_dict()
    assert json.dumps(got) == json.dumps(want)
    for cls in ("RecommendationRequest", "IntelligenceRequest",
                "BatchRecommendationRequest", "ErrorResponse"):
        body = ({"customer_ids": ["1"]} if cls.startswith("Batch")
                else {"error": "x"} if cls == "ErrorResponse"
                else {"customer_id": "1"})
        assert json.dumps(getattr(dtos, cls).from_dict(body).to_dict()) == \
            json.dumps(getattr(jdtos, cls).model_validate(body).model_dump())


def test_validation_error_lists_every_field():
    with pytest.raises(dtos.ValidationError) as e:
        dtos.RecommendationRequest.from_dict(
            {"num_recommendations": 0, "context": {"hour": "x"}})
    locs = [err["loc"] for err in e.value.errors()]
    assert locs == [("customer_id",), ("num_recommendations",),
                    ("context", "hour")]
    assert "3 validation error(s) for RecommendationRequest" in str(e.value)


def test_a_failure_is_a_500_and_an_error_record(apis, monkeypatch):
    ja, ta = apis
    for a in (ja, ta):
        def boom(*args, **kw):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(a.server, "recommend", boom)
        before = a.metrics.summary().get("errors", 0)
        status, body = a.dispatch("POST", R, {"customer_id": "1"})
        assert status == 500 and body["error"] == "internal error"
        assert body["detail"] == "kernel launch failed"
        assert a.metrics.summary()["errors"] == before + 1
        monkeypatch.undo()


def test_features_are_cached_per_customer(apis):
    _, ta = apis
    ta.dispatch("POST", R, {"customer_id": "33", "exclude_purchased": True})
    assert ta.cache.get_features("33") == ta.processor.get_features(33)


# ------------------------------------------------------------ live socket

@pytest.fixture(scope="module")
def live_api(apis):
    _, ta = apis
    httpd = api.serve(ta, host="127.0.0.1", port=0, background=True)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", ta
    httpd.shutdown()
    httpd.server_close()


def _request(url, method="GET", body=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestRoutes:
    def test_health(self, live_api):
        base, _ = live_api
        status, body, headers = _request(f"{base}/health")
        assert status == 200
        assert body["status"] == "healthy"
        assert "model_version" in body
        assert "no-store" in headers.get("Cache-Control", "")

    def test_recommendations(self, live_api):
        base, ta = live_api
        status, body, _ = _request(
            f"{base}/api/v1/recommendations", "POST",
            {"customer_id": "7", "num_recommendations": 5})
        assert status == 200
        assert body["customer_id"] == "7"
        recs = body["recommendations"]
        assert [r["rank"] for r in recs] == [1, 2, 3, 4, 5]
        scores = [r["score"] for r in recs]
        assert scores == sorted(scores, reverse=True)
        assert all(0.0 <= s <= 1.0 for s in scores)
        assert recs[0]["metadata"]["department"] is not None
        assert recs[0]["explanation"]
        assert body["inference_time_ms"] > 0
        # the socket's JSON is dispatch's
        _, direct = ta.dispatch("POST", "/api/v1/recommendations",
                                {"customer_id": "7", "num_recommendations": 5})
        assert _strip(body) == _strip(direct)

    def test_recommendations_with_context_and_exclusion(self, live_api):
        base, ta = live_api
        status, body, _ = _request(
            f"{base}/api/v1/recommendations", "POST",
            {"customer_id": "3", "num_recommendations": 4,
             "context": {"hour": 8, "day": 1, "month": 3, "day_of_year": 70},
             "exclude_purchased": True})
        assert status == 200
        assert len(body["recommendations"]) == 4
        seen = {h["item_id"] for h in ta.processor.get_features(3)["sequence"]}
        assert not seen & {int(r["product_id"])
                           for r in body["recommendations"]}

    def test_batch(self, live_api):
        base, _ = live_api
        status, body, _ = _request(
            f"{base}/api/v1/recommendations/batch", "POST",
            {"customer_ids": ["1", "2", "3"], "num_recommendations": 3})
        assert status == 200
        assert len(body["results"]) == 3
        assert body["total_time_ms"] > 0
        for res in body["results"]:
            assert len(res["recommendations"]) == 3

    def test_concurrent_posts(self, live_api):
        base, ta = live_api
        got, errors = {}, []
        barrier = threading.Barrier(16)

        def call(c):
            try:
                barrier.wait(timeout=30)
                got[c] = _request(f"{base}/api/v1/recommendations", "POST",
                                  {"customer_id": str(c)})[:2]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=call, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        for c, (status, body) in got.items():
            _, direct = ta.dispatch("POST", "/api/v1/recommendations",
                                    {"customer_id": str(c)})
            # coalesced into one batch: its sums may round in another
            # order than the single request's
            assert status == 200
            _assert_json_close(_strip(body), _strip(direct))

    def test_metrics_endpoint(self, live_api):
        base, _ = live_api
        _request(f"{base}/health")
        status, body, _ = _request(f"{base}/metrics")
        assert status == 200
        assert body["count"] >= 1
        assert "cache_hit_rate" in body
        assert "latency_ms_p50" in body

    def test_index_refresh(self, live_api):
        base, _ = live_api
        status, body, _ = _request(
            f"{base}/api/v1/index/refresh", "POST", {})
        assert status == 200
        assert body["status"] in ("refreshed", "reloaded")


class TestErrorHandling:
    def test_unknown_route_404(self, live_api):
        base, _ = live_api
        assert _request(f"{base}/nope")[0] == 404

    def test_validation_error_422(self, live_api):
        base, _ = live_api
        status, body, _ = _request(
            f"{base}/api/v1/recommendations", "POST",
            {"num_recommendations": 5})
        assert status == 422
        assert body["error"] == "validation error"

    def test_unknown_customer_404(self, live_api):
        base, _ = live_api
        status, _, _ = _request(f"{base}/api/v1/recommendations", "POST",
                                {"customer_id": "99999"})
        assert status == 404

    def test_bad_json_400(self, live_api):
        base, _ = live_api
        status, body, headers = _request(
            f"{base}/api/v1/recommendations", "POST", raw=b"{not json")
        assert status == 400 and body["error"] == "invalid JSON"
        assert "no-store" in headers.get("Cache-Control", "")

    def test_batch_limit_101(self, live_api):
        base, _ = live_api
        status, _, _ = _request(
            f"{base}/api/v1/recommendations/batch", "POST",
            {"customer_ids": [str(i) for i in range(101)]})
        assert status == 422


class TestDemoSurface:
    def test_intelligence_endpoint(self, live_api):
        base, _ = live_api
        status, body, _ = _request(
            f"{base}/api/v1/intelligence", "POST",
            {"customer_id": "3", "num_recommendations": 5})
        assert status == 200
        assert len(body["recommendations"]) == 5
        intel = body["intelligence"]
        assert len(intel["attention_head_importance"]) == 4
        assert len(intel["confidence"]["counts"]) == 10
        ci = intel["component_importance"]
        assert abs(ci["mf"] + ci["mlp"] - 1.0) < 1e-6
        assert len(intel["normalized_scores"]) == 5

    def test_intelligence_hourly(self, live_api):
        base, _ = live_api
        s9, b9, _ = _request(f"{base}/api/v1/intelligence", "POST",
                             {"customer_id": "3", "num_recommendations": 5,
                              "hour": 9})
        s17, b17, _ = _request(f"{base}/api/v1/intelligence", "POST",
                               {"customer_id": "3", "num_recommendations": 5,
                                "hour": 17})
        assert s9 == 200 and s17 == 200
        assert b9["hour"] == 9 and b17["hour"] == 17
        assert (b9["recommendations"] != b17["recommendations"]
                or b9["intelligence"]["normalized_scores"]
                != b17["intelligence"]["normalized_scores"])

    def test_intelligence_validation(self, live_api):
        base, _ = live_api
        assert _request(f"{base}/api/v1/intelligence", "POST",
                        {"customer_id": "3", "hour": 99})[0] == 422

    def test_demo_page_served(self, live_api):
        from ncf_tpu.api.demo_page import DEMO_HTML

        base, _ = live_api
        with urllib.request.urlopen(f"{base}/demo/", timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/html")
            assert "no-store" in resp.headers["Cache-Control"]
            html = resp.read().decode()
        assert html == DEMO_HTML
        assert "http://" not in html.replace("http://www.w3.org", "")
        assert "https://" not in html


def test_server_takes_256_waiting_connections():
    assert api.app._Server.request_queue_size == 256
    assert api.app._Server.daemon_threads


def test_demo_page_module_is_the_ports_own():
    path = os.path.join(os.path.dirname(api.__file__), "demo_page.py")
    with open(path) as f:
        assert "ncf_tpu." not in f.read().replace("ncf_tpu/api", "")


def test_packages_export_the_reference_names():
    import ncf_tpu.api
    import ncf_tpu.serving
    import ncf_tpu_torch.serving

    assert api.__all__ == ncf_tpu.api.__all__
    assert ncf_tpu_torch.serving.__all__ == ncf_tpu.serving.__all__
    for pkg in (api, ncf_tpu_torch.serving):
        assert all(hasattr(pkg, name) for name in pkg.__all__)
