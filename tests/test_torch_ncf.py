"""Port parity for NCF/NeuMF serving with the gather kernel B7: the plain
version of the row gather (which CPU tensors take) against the JAX Pallas
gather in interpret mode, ``ops.embedding.set_impl`` and the ``"pallas"``
gradient against ``jax.grad``, ``models/ncf.py`` (``apply`` and
``score_candidates``), ``BruteForceScorer`` and ``ModelServer`` for the
two baseline models, against ``ncf_tpu``.

Tolerances: the gather is equal bit for bit (a copy).  Logits in float32
compute within 1e-5 (f32 sums in another order); gradients within 1e-5 of
each leaf's largest magnitude (float32); a bf16 table's gradient within
2^-6 of each element's magnitude sum (both add duplicates in bf16, each
add rounding by up to half an ulp of the running sum, in another order).
Served ids equal and probabilities within 1e-5.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ncf_tpu.ops.embedding as jemb  # noqa: E402
import ncf_tpu.ops.pallas_embedding as jpe  # noqa: E402
from ncf_tpu.models import ncf as jncf  # noqa: E402
from ncf_tpu.serving import ModelServer as JServer  # noqa: E402
from ncf_tpu.serving.scorer import BruteForceScorer as JBrute  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import params_from_numpy, tree_leaves  # noqa: E402
from ncf_tpu_torch.models import get_model, ncf as tncf  # noqa: E402
from ncf_tpu_torch.ops import embedding as temb, gather  # noqa: E402
from ncf_tpu_torch.serving import BruteForceScorer, ModelServer  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

TEMPORAL = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}


@pytest.fixture
def pallas_impl(monkeypatch):
    """The port under ``set_impl("pallas")`` (B7's plain version here);
    the JAX package under ``"xla"``, whose forward is the same gather,
    unless a test switches it (its Pallas gather then runs in interpret
    mode).  Both reset to ``"xla"`` afterwards."""
    monkeypatch.setattr(jpe, "_pallas_gather",
                        functools.partial(jpe._pallas_gather, interpret=True))
    temb.set_impl("pallas")
    yield
    jemb.set_impl("xla")
    temb.set_impl("xla")


def _cfgs(name, users, items, dtype="float32"):
    out = []
    for cfg in (JConfig(), Config()):
        cfg.model.name = name
        cfg.model.num_users, cfg.model.num_items = users, items
        cfg.model.mf_dim = cfg.model.mlp_dim = 8
        cfg.model.mlp_hidden_dims = [16, 8, 4]
        cfg.model.compute_dtype = dtype
        cfg.serving.coalesce_requests = False
        out.append(cfg)
    return out


def _params(jcfg, seed=0):
    """JAX-initialised weights with the embedding tables spread (std 0.3,
    not 0.01), so the scores are not all ~0.5."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jncf.init(jax.random.PRNGKey(seed), jcfg.model))
    for name in ("gmf_user", "gmf_item", "mlp_user", "mlp_item"):
        tree[name] = tree[name] * np.float32(30.0)
    return tree


# ------------------------------------------------------------- the gather

@pytest.mark.parametrize("dtype,shape", [
    ("float32", (1000, 64)), ("bfloat16", (300, 32)), ("float32", (77, 6))])
def test_gather_plain_version_equals_the_reference_kernel(dtype, shape):
    rng = np.random.default_rng(0)
    table = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, shape[0], 1500).astype(np.int32)
    ids[:10] = ids[10:20]                     # duplicates
    jt = jnp.asarray(table).astype(dtype)
    want = np.asarray(jpe._pallas_gather(jt, jnp.asarray(ids),
                                         interpret=True).astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = gather.gather_rows(tt, torch.from_numpy(ids))
    assert got.dtype == tt.dtype and got.shape == (1500, shape[1])
    np.testing.assert_array_equal(got.float().numpy(), want)
    two_d = gather.gather_rows(tt, torch.from_numpy(ids[:40].reshape(8, 5)))
    assert torch.equal(two_d.reshape(40, -1), got[:40])


def test_set_impl_routes_lookups(monkeypatch):
    assert temb.get_impl() == "xla"
    with pytest.raises(ValueError):
        temb.set_impl("bogus")
    calls = []
    monkeypatch.setattr(temb, "pallas_embedding_lookup",
                        lambda t, i: calls.append(1) or t[i.long()])
    table = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([2, 0])
    try:
        temb.set_impl("pallas")
        assert temb.get_impl() == "pallas"
        np.testing.assert_array_equal(temb.embedding_lookup(table, ids),
                                      [[6, 7, 8], [0, 1, 2]])
    finally:
        temb.set_impl("xla")
    temb.embedding_lookup(table, ids)
    assert calls == [1]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_pallas_gradient_matches_the_reference(pallas_impl, dtype):
    """The backward scatter-adds in the table's dtype, duplicates summed:
    the reference's backward (``pallas_embedding._bwd``) and ``jax.grad``
    of the gather (the same scatter; the reference's custom VJP itself
    does not trace under ``jax.grad``: its residuals hold the dtype)."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (30, 4)).astype(np.int32)
    ids[0] = ids[1]
    w = rng.normal(size=(30, 4, 16)).astype(np.float32)
    jt = jnp.asarray(table).astype(dtype)
    bwd, _ = jpe._bwd((jnp.asarray(ids), jt.shape, jt.dtype),
                      jnp.asarray(w).astype(dtype))
    grad = jax.grad(lambda t: (jnp.take(t, jnp.asarray(ids), axis=0).astype(
        jnp.float32) * w).sum())(jt)
    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_()
    (temb.embedding_lookup(tt, torch.from_numpy(ids)).float()
     * torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == tt.dtype
    got = tt.grad.float().numpy()
    for want in (bwd, grad):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            mag = np.zeros_like(table)
            np.add.at(mag, ids.reshape(-1), np.abs(w).reshape(-1, 16))
            assert (np.abs(got - want) <= 2.0 ** -6 * mag).all()


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("name", ("ncf", "neumf"))
def test_init_matches_the_reference_pytree(name):
    jcfg, tcfg = _cfgs(name, 40, 30)
    jtree = jax.eval_shape(lambda k: jncf.init(k, jcfg.model),
                           jax.random.PRNGKey(0))
    ttree = get_model(name).init(torch.Generator(), tcfg.model)
    assert jax.tree.map(lambda a: tuple(a.shape), jtree) == jax.tree.map(
        lambda a: tuple(a.shape), ttree)
    meta = tncf.init(torch.Generator(), tcfg.model, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))


@pytest.mark.parametrize("impl", ("xla", "pallas"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_apply_and_score_candidates_match(pallas_impl, impl, dtype):
    jcfg, tcfg = _cfgs("neumf", 40, 30, dtype)
    np_params = _params(jcfg)
    temb.set_impl(impl)
    jemb.set_impl(impl)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 40, 12).astype(np.int32)
    items = rng.integers(0, 30, (12, 7)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    want = np.asarray(jncf.apply(jp, jcfg.model, jnp.asarray(u),
                                 jnp.asarray(items)))
    got = tncf.apply(tp, tcfg.model, torch.from_numpy(u),
                     torch.from_numpy(items))
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    got = tncf.score_candidates(tp, tcfg.model, torch.from_numpy(u),
                                torch.from_numpy(items))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    emb = tncf.get_user_embeddings(tp, torch.from_numpy(u))
    np.testing.assert_array_equal(emb["mf"].numpy(), np_params["gmf_user"][u])
    emb = tncf.get_product_embeddings(tp, tcfg.model,
                                      torch.from_numpy(items[0]))
    np.testing.assert_array_equal(emb["mlp"].numpy(),
                                  np_params["mlp_item"][items[0]])


def test_training_gradients_match(pallas_impl):
    """Every parameter's gradient of a weighted logit sum, the port's
    lookups through the gather kernel's plain version and its backward,
    against ``jax.grad`` of the reference's gathers."""
    jcfg, tcfg = _cfgs("ncf", 40, 30)
    np_params = _params(jcfg, seed=3)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 40, 16).astype(np.int32)
    items = rng.integers(0, 30, (16, 5)).astype(np.int32)
    w = rng.normal(size=(16, 5)).astype(np.float32)

    def jloss(p):
        return (jncf.apply(p, jcfg.model, jnp.asarray(u), jnp.asarray(items),
                           deterministic=True) * w).sum()

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, np_params))
    tp = params_from_numpy(np_params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    (tncf.apply(tp, tcfg.model, torch.from_numpy(u), torch.from_numpy(items),
                deterministic=True) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip(tree_leaves(tp), jax.tree_util.tree_leaves(want)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max() + 1e-9)


# ------------------------------------------------------------- serving

def _same(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", (4096, 7))
def test_brute_force_scorer_matches(pallas_impl, chunk):
    jcfg, tcfg = _cfgs("ncf", 50, 37)
    np_params = _params(jcfg, seed=4)
    js = JBrute(jncf, jax.tree.map(jnp.asarray, np_params), jcfg.model,
                chunk=chunk)
    ts = BruteForceScorer(get_model("ncf"), params_from_numpy(np_params,
                                                              "cpu"),
                          tcfg.model, chunk=chunk)
    users = np.asarray([0, 3, 49, 20])
    _same(ts.topk_for_users(users, k=10), js.topk_for_users(users, k=10))
    _same(ts.topk_for_users(users, k=10, temporal=TEMPORAL),
          js.topk_for_users(users, k=10, temporal=TEMPORAL))
    exclude = np.asarray([[1, 2, 3, -1], [4, 5, -1, -1], [-1] * 4,
                          [30, 31, 32, 33]], np.int32)
    exclude[0, :3] = ts.topk_for_users(users[:1], k=3)[1][0]
    got = ts.topk_for_users(users, k=10, exclude=exclude)
    _same(got, js.topk_for_users(users, k=10, exclude=exclude))
    assert not set(exclude[0]) & set(got[1][0])
    # the whole catalog: more than k survivors are missing for nobody
    _same(ts.topk_for_users(users, k=37), js.topk_for_users(users, k=37))


@pytest.mark.parametrize("name", ("ncf", "neumf"))
def test_model_server_matches(pallas_impl, name):
    jcfg, tcfg = _cfgs(name, 60, 45)
    np_params = _params(jcfg, seed=5)
    js = JServer(jcfg, params=jax.tree.map(jnp.asarray, np_params))
    ts = ModelServer(tcfg, params=params_from_numpy(np_params, "cpu"),
                     device="cpu")
    try:
        assert isinstance(ts.scorer, BruteForceScorer)
        _same(ts.recommend(11, k=5)[:2], js.recommend(11, k=5)[:2])
        _same(ts.recommend(11, k=5, exclude_items=[1, 2, 3])[:2],
              js.recommend(11, k=5, exclude_items=[1, 2, 3])[:2])
        _same(ts.recommend_hourly(7, hour=8, k=5)[:2],
              js.recommend_hourly(7, hour=8, k=5)[:2])
        users = np.arange(0, 60, 7)
        _same(ts.recommend_batch(users, k=10)[:2],
              js.recommend_batch(users, k=10)[:2])
        np.testing.assert_allclose(ts.get_predictions(42, [3, 4, 44]),
                                   js.get_predictions(42, [3, 4, 44]),
                                   rtol=0, atol=1e-5)
        for key in ("mf", "mlp"):
            np.testing.assert_array_equal(
                ts.get_user_embedding([1, 2])[key],
                js.get_user_embedding([1, 2])[key])
    finally:
        js.close()
        ts.close()


def test_model_server_reloads_an_ncf_checkpoint(tmp_path):
    """``from_checkpoint``/``reload`` take the NCF template; the npy
    manifest the JAX package writes loads in the port."""
    from ncf_tpu.train import checkpoint as jckpt

    jcfg, tcfg = _cfgs("neumf", 30, 20)
    np_params = _params(jcfg, seed=6)
    path = jckpt.save(str(tmp_path), {"params": jax.tree.map(jnp.asarray,
                                                             np_params)},
                      step=7)
    ts = ModelServer.from_checkpoint(tcfg, path, device="cpu")
    try:
        assert ts.model_version == "ckpt-7"
        for name in ("gmf_user", "mlp_item"):
            np.testing.assert_array_equal(ts.params[name].numpy(),
                                          np_params[name])
        np.testing.assert_array_equal(ts.params["mlp"][1]["dense"]["w"],
                                      np_params["mlp"][1]["dense"]["w"])
        ts.reload(path)
        assert isinstance(ts.scorer, BruteForceScorer)
    finally:
        ts.close()
