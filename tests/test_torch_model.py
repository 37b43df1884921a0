"""Port parity for the model: layers, temporal encoding and AdvancedNCF
(eval mode) against ``ncf_tpu`` on the demo checkpoint (8031 users x 366
items), loaded into both packages.

Tolerances: float32 compute atol 1e-5 (sums in another order); bfloat16
compute atol 2e-2, because bf16 rounds intermediate activations and an
ulp of difference before a rounding moves the result by up to 2^-8.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.models import layers as jlayers  # noqa: E402
from ncf_tpu.models import temporal as jtemporal  # noqa: E402
from ncf_tpu.utils.config import ModelConfig as JModelConfig  # noqa: E402
from ncf_tpu_torch.convert import (params_from_numpy,  # noqa: E402
                                   params_to_numpy)
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.models import get_model  # noqa: E402
from ncf_tpu_torch.models import layers as tlayers  # noqa: E402
from ncf_tpu_torch.models import temporal as ttemporal  # noqa: E402
from ncf_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ncf_tpu_torch.utils.config import ModelConfig  # noqa: E402

DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "demo", "checkpoint")
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def demo():
    jcfg = JModelConfig()
    template = tmodel.init(torch.Generator(), ModelConfig(), device="meta")
    state, _ = tckpt.restore(DEMO, {"params": template}, "cpu")
    np_params = params_to_numpy(state["params"])
    rng = np.random.default_rng(0)
    dept = rng.integers(0, jcfg.num_departments, jcfg.num_items).astype(np.int32)
    cat = rng.integers(0, jcfg.num_categories, jcfg.num_items).astype(np.int32)
    return {"jax": jax.tree.map(jnp.asarray, np_params),
            "torch": params_from_numpy(np_params, "cpu"),
            "dept": dept, "cat": cat}


def _cfgs(dtype):
    jc, tc = JModelConfig(), ModelConfig()
    jc.compute_dtype = tc.compute_dtype = dtype
    return jc, tc


def _close(got, want, dtype):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=0, atol=ATOL[dtype])


def _temporal(B, rng):
    t = {"hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
         "month": rng.integers(0, 12, B),
         "day_of_year": rng.integers(0, 1000, B)}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in t.items()},
            {k: torch.from_numpy(v) for k, v in t.items()})


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_layer_norm_and_tower(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32) * 0.3
    b = rng.normal(size=(16,)).astype(np.float32)
    jp, tp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}, \
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    _close(tlayers.dense(tp, torch.from_numpy(x), td),
           jlayers.dense(jp, jnp.asarray(x), jd), dtype)

    ln = {"scale": rng.normal(size=24).astype(np.float32),
          "bias": rng.normal(size=24).astype(np.float32)}
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    jln = {k: jnp.asarray(v) for k, v in ln.items()}
    _close(tlayers.layer_norm(tln, torch.from_numpy(x)),
           jlayers.layer_norm(jln, jnp.asarray(x)), "float32")
    got = tlayers.layer_norm(tln, torch.from_numpy(x).to(td))
    assert got.dtype == td                    # normalises in f32, casts back
    _close(got, jlayers.layer_norm(jln, jnp.asarray(x, jd)), dtype)

    layers = []
    cur = 24
    for h in (32, 16):
        layers.append({
            "dense": {"w": rng.normal(size=(cur, h)).astype(np.float32) * 0.2,
                      "b": rng.normal(size=h).astype(np.float32)},
            "norm": {"scale": rng.normal(size=h).astype(np.float32),
                     "bias": rng.normal(size=h).astype(np.float32)}})
        cur = h
    _close(tlayers.mlp_tower(params_from_numpy(layers, "cpu"),
                             torch.from_numpy(x), dtype=td),
           jlayers.mlp_tower(jax.tree.map(jnp.asarray, layers),
                             jnp.asarray(x), dtype=jd), dtype)


def test_training_dropout_is_not_ported_yet():
    # training dropout is ported now: without a generator, or in eval
    # mode, it is the identity; with one it is inverted dropout whose
    # masks come from that generator (a key of another kind is refused)
    x = torch.ones(3)
    assert tlayers.dropout(None, x, 0.5, False) is x
    assert tlayers.dropout(torch.Generator(), x, 0.5, True) is x
    with pytest.raises(TypeError):
        tlayers.dropout(object(), x, 0.5, False)
    y = torch.ones((400, 250), dtype=torch.bfloat16)
    out = tlayers.dropout(torch.Generator().manual_seed(0), y, 0.2, False)
    assert out.dtype == torch.bfloat16
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.equal(out[kept], torch.full_like(out[kept], 1.25))
    again = tlayers.dropout(torch.Generator().manual_seed(0), y, 0.2, False)
    assert torch.equal(out, again)


def test_init_matches_the_pytree(demo):
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init(gen, ModelConfig())
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                           demo["jax"])
    tshapes = jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
        params)
    assert jshapes == tshapes
    meta = tmodel.init(gen, ModelConfig(), device="meta")
    assert meta["user_emb"].device.type == "meta"
    # the sequence block is ported now: its pytree matches the reference's
    seq = tmodel.init(gen, ModelConfig(use_sequence=True), device="meta")
    jseq = jax.eval_shape(lambda k: jmodel.init(
        k, JModelConfig(use_sequence=True)), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: tuple(a.shape), seq) == \
        jax.tree.map(lambda a: tuple(a.shape), jseq)
    # NCF and NeuMF are ported now (tests/test_torch_ncf.py)
    assert get_model("ncf") is get_model("neumf")
    assert get_model("ncf").init is not tmodel.init
    with pytest.raises(ValueError):
        get_model("no-such-model")


def test_temporal_apply(demo):
    rng = np.random.default_rng(2)
    jt, tt = _temporal(33, rng)
    np.testing.assert_allclose(ttemporal.sinusoidal_table(32).numpy(),
                               np.asarray(jtemporal.sinusoidal_table(32)),
                               rtol=0, atol=1e-6)
    _close(ttemporal.apply(demo["torch"]["temporal"], tt["hour"], tt["day"],
                           tt["month"], tt["day_of_year"]),
           jtemporal.apply(demo["jax"]["temporal"], jt["hour"], jt["day"],
                           jt["month"], jt["day_of_year"]), "float32")


# ------------------------------------------------------------- AdvancedNCF

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("candidate_attention", (True, False))
@pytest.mark.parametrize("B,S", ((4, 6), (64, 40)))   # vocab off / on
def test_apply(demo, dtype, candidate_attention, B, S):
    jc, tc = _cfgs(dtype)
    assert tmodel._use_vocab_precompute(tc, B * S) == \
        jmodel._use_vocab_precompute(jc, B * S) == (B * S >= 2100)
    rng = np.random.default_rng(B + S)
    users = rng.integers(0, jc.num_users, B).astype(np.int32)
    items = rng.integers(0, jc.num_items, (B, S)).astype(np.int32)
    jt, tt = _temporal(B, rng)
    want = jax.jit(lambda p, *a: jmodel.apply(
        p, jc, *a, candidate_attention=candidate_attention))(
        demo["jax"], jnp.asarray(users), jnp.asarray(items), jt,
        jnp.asarray(demo["dept"]), jnp.asarray(demo["cat"]))
    got = tmodel.apply(demo["torch"], tc, torch.from_numpy(users),
                       torch.from_numpy(items), tt,
                       torch.from_numpy(demo["dept"]),
                       torch.from_numpy(demo["cat"]),
                       candidate_attention=candidate_attention)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_score_candidates_without_temporal(demo, dtype):
    jc, tc = _cfgs(dtype)
    users = np.arange(5, dtype=np.int32)
    items = np.tile(np.arange(jc.num_items, dtype=np.int32)[None], (5, 1))
    want = jax.jit(lambda p, *a: jmodel.score_candidates(p, jc, *a))(
        demo["jax"], jnp.asarray(users), jnp.asarray(items), None,
        jnp.asarray(demo["dept"]), jnp.asarray(demo["cat"]))
    got = tmodel.score_candidates(demo["torch"], tc, torch.from_numpy(users),
                                  torch.from_numpy(items), None,
                                  torch.from_numpy(demo["dept"]),
                                  torch.from_numpy(demo["cat"]))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_hour", (True, False))
def test_score_items_with_hour(demo, dtype, with_hour):
    jc, tc = _cfgs(dtype)
    rng = np.random.default_rng(4)
    users = rng.integers(0, jc.num_users, 17).astype(np.int32)
    items = rng.integers(0, jc.num_items, 17).astype(np.int32)
    hour = rng.integers(0, 24, 17).astype(np.int32) if with_hour else None
    want = jmodel.score_items_with_hour(
        demo["jax"], jc, jnp.asarray(users), jnp.asarray(items),
        None if hour is None else jnp.asarray(hour))
    got = tmodel.score_items_with_hour(
        demo["torch"], tc, torch.from_numpy(users), torch.from_numpy(items),
        None if hour is None else torch.from_numpy(hour))
    _close(got, want, dtype)


def test_embedding_exports(demo):
    jc, tc = _cfgs("float32")
    ids = np.asarray([0, 3, 365, 17], np.int32)
    ju = jmodel.get_user_embeddings(demo["jax"], jnp.asarray(ids))
    tu = tmodel.get_user_embeddings(demo["torch"], torch.from_numpy(ids))
    jp = jmodel.get_product_embeddings(demo["jax"], jc, jnp.asarray(ids),
                                       jnp.asarray(demo["dept"]),
                                       jnp.asarray(demo["cat"]))
    tp = tmodel.get_product_embeddings(demo["torch"], tc,
                                       torch.from_numpy(ids),
                                       torch.from_numpy(demo["dept"]),
                                       torch.from_numpy(demo["cat"]))
    assert set(ju) == set(tu) and set(jp) == set(tp) == {"mf", "mlp",
                                                         "category"}
    for k in ju:
        _close(tu[k], ju[k], "float32")
    for k in jp:
        _close(tp[k], jp[k], "float32")
