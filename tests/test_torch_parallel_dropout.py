"""Dropout under a mesh: the port's mesh steps on 2 and 4 gloo ranks
against its one-process steps, with dropout 0.3 on the plain layers.

Every rank seeds the step's generator alike and keeps its rows of each
mask drawn for the whole (the batch, or the item table for the category
hierarchy of a table shard), so an N-rank step takes the masks the
one-rank step takes and follows it within ``tests/
test_torch_train_step.py``'s step tolerance (5e-5 of each leaf's largest
magnitude): params, and the Adam moments or the rowwise accumulators.
Cases: ``(1, 2)`` precompute branch, joint (the hierarchy over the item
shard); ``(2, 2)`` precompute off, independent (the hierarchy over the
batch's rows); ``(1, 4)`` the sequence path's attention; ``(2, 2)`` the
sparse step with the sequence path and the clip on.  f32 with the
fused tower off: the fused tower folds the rank into its seed instead,
as the reference's does (``tests/test_torch_parallel_train.py``).  The
negatives are given, so the generator draws only the masks.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

from ncf_tpu_torch.convert import tree_map  # noqa: E402
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.data.sampler import make_sampling_cdf  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.ops import embedding as temb  # noqa: E402
from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.train.checkpoint import _leaves_with_path  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

STEP_REL = 5e-5
SEED = 11


def _cfg(users, items, batch, mode, seq, sparse):
    cfg = Config()
    m, t = cfg.model, cfg.train
    m.num_users, m.num_items = users, items
    m.mf_dim = m.mlp_dim = 8
    m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
    m.num_departments, m.num_categories = 3, 5
    m.negative_samples, m.fused_tower = 4, "off"
    m.compute_dtype, m.dropout = "float32", 0.3
    m.candidate_mode, m.use_sequence, m.history_len = mode, seq, 5
    t.batch_size, t.num_epochs = batch, 1
    t.weight_decay, t.gradient_clip_norm = 1e-3, 0.05
    t.embedding_scatter = "xla"
    if sparse:
        t.embedding_optimizer = "rowwise_adagrad"
        t.embedding_learning_rate = 0.01
        t.sparse_table_update = "on"
    return cfg


def _flat(tree, prefix):
    return {f"{prefix}.{p}": v.detach().numpy()
            for p, v in _leaves_with_path(tree)}


def _one_rank(cfg, params, batches, negs, consts, hist, sparse):
    """The one-process steps from ``params`` with the workers' seed."""
    K = len(batches)
    params = tree_map(torch.clone, params)        # the steps update in place
    if sparse:
        dense_opt = toptim.make_optimizer(dataclasses.replace(
            cfg.train, gradient_clip_norm=0.0), K)
        state = tstep.init_sparse_opt_state(dense_opt, params)
        step = tstep.make_sparse_train_step(
            tmodel, cfg, dense_opt, toptim.make_schedule(cfg.train, K),
            *consts, user_history=hist, device="cpu")
    else:
        opt = toptim.make_optimizer(cfg.train, K)
        state = opt.init(params)
        step = tstep.make_train_step(tmodel, cfg, opt, *consts, hist,
                                     device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    temb.set_scatter_impl("xla")
    try:
        for b, n in zip(batches, negs):
            params, state, gen, _ = step(params, state, gen, b, n)
    finally:
        temb.set_scatter_impl("auto")
    return params, state


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = max(STEP_REL * np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(),
                                            tol)


@pytest.mark.parametrize("dcn,ici,vocab,mode,seq,sparse", [
    (1, 2, True, "joint", False, False),
    (2, 2, False, "independent", False, False),
    (1, 4, True, "independent", True, False),
    (2, 2, False, "joint", True, True),
])
def test_mesh_step_with_dropout_matches_one_rank(tmp_path, dcn, ici, vocab,
                                                 mode, seq, sparse):
    users, items, B = ((100, 60, 64) if vocab
                       else (900, 600, 64) if sparse else (400, 300, 16))
    K = 3
    cfg = _cfg(users, items, B, mode, seq, sparse)
    assert tmodel._use_vocab_precompute(cfg.model, B * 5) == vocab
    rng = np.random.default_rng(0)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    cdf = make_sampling_cdf(1.0 / rng.zipf(1.3, items)).numpy()
    inter = generate_interactions(num_users=users, num_items=items,
                                  num_days=30, avg_txns_per_user=6, seed=0)
    batches = list(itertools.islice(BatchIterator(inter, B, seed=0).epoch(0),
                                    K))
    hist = inter.recent_history(5) if seq else None
    negs = [rng.integers(0, items, (B, 4)).astype(np.int32)
            for _ in range(K)]
    params = tmodel.init(torch.Generator().manual_seed(0), cfg.model,
                         device="cpu")

    arrays = _flat(params, "params")
    for k, b in enumerate(batches):
        arrays.update({f"batch{k}.{c}": v for c, v in b.items()})
        arrays[f"negs{k}"] = negs[k]
    arrays.update(cdf=cdf, dept=dept, cat=cat)
    if hist is not None:
        arrays["user_history"] = hist
    io = str(tmp_path / "io")
    workers.save_inputs(io, arrays, {
        "config": cfg.to_dict(), "steps": K, "seed": SEED,
        "mode": "sparse" if sparse else "dense",
        "columns": sorted(batches[0]), "scatter": ["xla", "split"]})
    workers.run("step", dcn * ici, io, dcn=dcn, device="cpu")
    out, _ = workers.load_outputs(io, 0)

    consts = (cdf, dept, cat)
    one, state = _one_rank(cfg, params, batches, negs, consts, hist, sparse)
    cfg.model.dropout = 0.0
    plain, _ = _one_rank(cfg, params, batches, negs, consts, hist, sparse)
    moved = False
    for (p, want), (_, off) in zip(_leaves_with_path(one),
                                   _leaves_with_path(plain)):
        _close(out[f"params.{p}"], want.numpy(), f"params.{p}")
        moved |= not np.allclose(want.numpy(), off.numpy(), rtol=1e-3)
    assert moved                                  # the masks took effect
    if sparse:
        for k in ("user_acc", "item_acc"):
            _close(out[k], state[k].numpy(), k)
    else:
        for mom in ("mu", "nu"):
            for p, want in _leaves_with_path(state[mom]):
                _close(out[f"{mom}.{p}"], want.numpy(), f"{mom}.{p}")
