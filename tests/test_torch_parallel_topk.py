"""Item-sharded top-k: the port's ``sharded_topk_scores`` and
``sharded_topk_scores_prepared`` (f32 and int8) on 2 and 4 gloo ranks
against the JAX package's on its CPU mesh (its Pallas kernels in
interpret mode) and against the port's single-device answers.

Planted ties: rows copied across shard boundaries score equal, and the
merge must give them to the lower id as ``lax.top_k`` does.  The
catalog's shards are multiples of the streaming segment (128 for
``impl="streaming"``, the prepared tiers' ``block_items``), so the
sharded streaming answers equal the single-device ones (the streaming
answer is held to the port's single-device streaming answer only: with
more than ``seg_top`` of the top-k in one segment it is not the exact
top-k); ids are held equal (int8: where the slot is filled), values
within rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.parallel import sharded_topk as jst  # noqa: E402
from ncf_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ncf_tpu_torch.ops import topk as ttopk  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402

IMPLS = ["dense", "xla", "streaming", "pallas"]


def _inputs(I, D, B, seed):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(I, D)).astype(np.float32)
    bias = (0.1 * rng.normal(size=I)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    # planted ties across shards: copies of the users' favourite row
    best = int(np.argmax(q[0] @ items.T + bias))
    for j in (I // 4 + 3, I // 2 + 1, I - 2):
        items[j] = items[best]
        bias[j] = bias[best]
    return items, bias, q


def _close_and_equal(v, i, rv, ri, what, filled=None):
    if filled is None:
        np.testing.assert_array_equal(i, ri, err_msg=what)
        np.testing.assert_allclose(v, rv, rtol=1e-6, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(np.where(filled, i, -1),
                                      np.where(filled, ri, -1), err_msg=what)


@pytest.mark.parametrize("ici", [2, 4])
def test_sharded_topk_matches_reference_and_one_device(tmp_path, ici):
    I, D, B, k = 1024, 16, 5, 10
    items, bias, q = _inputs(I, D, B, seed=ici)
    qsample = np.abs(q).max(0, keepdims=True)
    io = str(tmp_path / "io")
    workers.save_inputs(io, {"items": items, "bias": bias, "queries": q,
                             "qsample": qsample},
                        {"k": k, "impls": IMPLS, "block_items": 64,
                         "seg_width": 16, "int8_seg_top": 1})
    workers.run("topk", ici, io, device="cpu")
    outs = [workers.load_outputs(io, r)[0] for r in range(ici)]
    for o in outs[1:]:                         # the same on every rank
        for key in o:
            np.testing.assert_array_equal(o[key], outs[0][key])
    o = outs[0]

    mesh = jmake_mesh(dcn=1, ici=ici, devices=jax.devices()[:ici])
    ji, jb = jnp.asarray(items), jnp.asarray(bias)
    items_s, bias_s, n = jst.shard_items(ji, jb, mesh)
    jv, jidx = jst.sharded_topk_scores(jnp.asarray(q), items_s, bias_s, n,
                                       mesh, k=k, impl="xla")
    tq, ti, tb = (torch.from_numpy(x) for x in (q, items, bias))
    for impl in IMPLS:
        if impl != "streaming":        # exact; streaming is segment-limited
            _close_and_equal(o[f"{impl}_v"], o[f"{impl}_i"], np.asarray(jv),
                             np.asarray(jidx), f"{impl} vs the reference")
        sv, si = ttopk.topk_scores(tq, ti, k, tb, impl=impl)
        _close_and_equal(o[f"{impl}_v"], o[f"{impl}_i"], sv.numpy(),
                         si.numpy(), f"{impl} vs one device")
    # the planted ties: the lower id first
    row = o["dense_i"][0]
    ties = [j for j in row if np.array_equal(items[j], items[row[0]])]
    assert len(ties) >= 2 and ties == sorted(ties)

    prep = jst.shard_prepare_items(ji, jb, mesh, block_items=64, seg_width=16)
    pv, pi = jst.sharded_topk_scores_prepared(jnp.asarray(q), prep, mesh,
                                              k=k, interpret=True)
    _close_and_equal(o["prep_v"], o["prep_i"], np.asarray(pv),
                     np.asarray(pi), "prepared vs the reference")
    sv, si = ttopk.topk_scores_streaming(tq, ti, k, tb, block_items=64,
                                         seg_width=16, seg_top=2)
    _close_and_equal(o["prep_v"], o["prep_i"], sv.numpy(), si.numpy(),
                     "prepared vs one device")

    prep8 = jst.shard_prepare_items_int8(ji, jb, jnp.asarray(qsample), mesh,
                                         block_items=64, seg_width=16)
    v8, i8 = jst.sharded_topk_scores_prepared(jnp.asarray(q), prep8, mesh,
                                              k=k, seg_top=1, interpret=True)
    filled = np.asarray(v8) > -1e38
    _close_and_equal(o["int8_v"], o["int8_i"], None, np.asarray(i8),
                     "int8 vs the reference", filled)
    np.testing.assert_array_equal(o["int8_v"], np.asarray(v8))
    one = ttopk.prepare_items_int8(ti, tb, torch.from_numpy(qsample),
                                   block_items=64, seg_width=16)
    sv, si = ttopk.topk_scores_streaming_int8(tq, one, k, seg_top=1)
    _close_and_equal(o["int8_v"], o["int8_i"], None, si.numpy(),
                     "int8 vs one device", sv.numpy() > -1e38)
    np.testing.assert_array_equal(o["int8_v"], sv.numpy())
