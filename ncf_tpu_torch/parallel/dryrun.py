"""``dryrun_multichip``: every part of the parallel layer once, on N ranks.

The port's counterpart of ``__graft_entry__.dryrun_multichip``.  It
starts N ranks (``multihost.run_ranks``; on the card they share it over
gloo) and on the meshes ``(1, N)`` and ``(2, N / 2)`` runs, at tiny
shapes: the training step with row-sharded tables, the rowwise-Adagrad
table optimizer with sharded accumulators, the step through the
all-to-all exchange on ``(2, N / 2)``, ``ShardedEmbedding``'s lookup and
gradient, the sharded sparse update with the sequence path,
``DeviceEvaluator`` over the mesh, the item-sharded top-k (exact,
prepared and int8), the fused tower under the mesh and the sequence
path under the mesh.  Every sharded result is held to the one-rank
result, which each rank computes on its own device from the same inputs;
on the card every kernel of those paths runs (B1, B2, B4f/B4b, B5, B6,
B8; B3 takes batches of 4,096 rows or more, and these are tiny).  Rank 0 prints the reference's line of tokens:

    dryrun_multichip(n=4): ok, loss=..., sharded_tables=2, ...,
    all_to_all=ok, sparse_sharded_seq(dcn=2,ici=2)=ok, sharded_eval(...)=ok,
    sharded_topk=ok, sharded_topk_prepared=ok, sharded_topk_int8=ok,
    fused_tower_mesh=ok, sequence_mesh=ok

    python -m ncf_tpu_torch.parallel.dryrun [--n 4] [--device cuda|cpu]

The ranks run on the card unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MODULE = "ncf_tpu_torch.parallel.dryrun"
REL = 5e-5          # tests/test_torch_train_step.py's step tolerance


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> str:
    """Run the dryrun on ``n_devices`` ranks; returns rank 0's token
    line (raises if any rank failed)."""
    return dryrun_report(n_devices, device, timeout)[0]


def dryrun_report(n_devices: int, device: str = "cuda",
                  timeout: float = 600.0):
    """(rank 0's token line, each rank's kernel launches) of the dryrun."""
    import json

    from ncf_tpu_torch.parallel.multihost import run_ranks

    if n_devices % 2:
        raise ValueError("the dryrun takes an even number of ranks")
    outs = run_ranks(MODULE, n_devices, ["--device", device],
                     timeout=timeout, capture=True)
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("dryrun_multichip(")]
    if not line:
        raise RuntimeError(f"no token line from rank 0:\n{outs[0]}")
    launches = [json.loads(ln.split(": ", 1)[1]) for out in outs
                for ln in out.splitlines()
                if ln.startswith("dryrun_launches: ")]
    return line[-1], launches


# --------------------------------------------------------------- helpers

def _cfg(n, **model):
    from ncf_tpu_torch.utils.config import Config

    cfg = Config()
    m, t = cfg.model, cfg.train
    m.num_users, m.num_items = 8 * n, 8 * n
    m.mf_dim = m.mlp_dim = 16
    m.temporal_dim, m.mlp_hidden_dims = 8, [32, 16]
    m.compute_dtype, m.dropout, m.fused_tower = "float32", 0.0, "off"
    m.num_departments, m.num_categories = 9, 30
    t.batch_size = 4 * n
    t.embedding_scatter = "xla"
    for k, v in model.items():
        setattr(m if hasattr(m, k) else t, k, v)
    return cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, m = cfg.train.batch_size, cfg.model
    return {"user_ids": rng.integers(0, m.num_users, B),
            "item_ids": rng.integers(0, m.num_items, B),
            "hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
            "month": rng.integers(0, 12, B),
            "day_of_year": rng.integers(0, 365, B)}


def _consts(cfg, dev, seed=0):
    from ncf_tpu_torch.data.sampler import make_sampling_cdf

    rng = np.random.default_rng(seed)
    m = cfg.model
    return (make_sampling_cdf(np.ones(m.num_items), device=dev),
            rng.integers(0, m.num_departments, m.num_items).astype(np.int32),
            rng.integers(0, m.num_categories, m.num_items).astype(np.int32))


# the kernel launches of the mesh runs only (not of the one-rank results
# they are held to)
_TALLY: dict = {}


def _mesh(fn, *args, **kw):
    """``fn(*args, **kw)``, its kernel launches added to ``_TALLY``."""
    from ncf_tpu_torch.ops import launch_counters

    counters = launch_counters()
    before = {k: c.value for k, c in counters.items()}
    out = fn(*args, **kw)
    for k, c in counters.items():
        _TALLY[k] = _TALLY.get(k, 0) + c.value - before[k]
    return out


def _close(got, want, what, rel=REL):
    from ncf_tpu_torch.convert import params_to_numpy, tree_leaves

    for a, b in zip(tree_leaves(params_to_numpy(got)),
                    tree_leaves(params_to_numpy(want))):
        tol = max(rel * float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a.astype(np.float64) - b).max())
        if err > tol:
            raise AssertionError(f"{what}: {err} > {tol}")


def _train(cfg, mesh, dev, steps=2, sparse=False, hist=None):
    """``steps`` steps from the seeded params over ``mesh`` (None: one
    rank); returns (params gathered whole, last loss, the specs, the
    state)."""
    import dataclasses

    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel.mesh import (SHARDED, gather_pytree,
                                             param_shardings, shard_pytree)
    from ncf_tpu_torch.train import optim, step as step_lib

    model = get_model(cfg.model.name)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    specs = None
    emb.clear_exchange()
    if mesh is not None:
        specs = param_shardings(params, mesh)
        rows = {k: params[k].shape[0] for k, s in specs.items()
                if s == SHARDED}
        if rows:
            emb.set_exchange(mesh, rows, 0.0)
        params = shard_pytree(params, specs, mesh)
    emb.set_scatter_impl("xla")
    cdf, dept, cat = _consts(cfg, dev)
    if sparse:
        dense_opt = optim.make_optimizer(dataclasses.replace(
            cfg.train, gradient_clip_norm=0.0), 10)
        state = step_lib.init_sparse_opt_state(dense_opt, params)
        fn = step_lib.make_sparse_train_step(
            model, cfg, dense_opt, optim.make_schedule(cfg.train, 10), cdf,
            dept, cat, mesh=mesh, user_history=hist, device=dev)
    else:
        opt = optim.make_optimizer(cfg.train, 10)
        state = opt.init(params)
        fn = step_lib.make_train_step(model, cfg, opt, cdf, dept, cat, hist,
                                      device=dev, mesh=mesh, shardings=specs)
    gen = torch.Generator(device=dev).manual_seed(1)
    loss = None
    for s in range(steps):
        params, state, gen, m = fn(params, state, gen, _batch(cfg, s))
        loss = float(m["loss"])
    emb.clear_exchange()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    whole = params if mesh is None else gather_pytree(params, specs, mesh)
    return whole, loss, specs, state


# ------------------------------------------------------------ the ranks

def _run(dev) -> str:
    from ncf_tpu_torch.parallel.mesh import (ICI_AXIS, SHARDED, WORLD,
                                             make_mesh)

    from ncf_tpu_torch.parallel import multihost

    n = multihost.process_count()
    mesh = make_mesh(dcn=1, ici=n)
    mesh2 = make_mesh(dcn=2, ici=n // 2)
    tok = {}

    # the step with row-sharded tables, against one rank
    cfg = _cfg(n)
    got, loss, specs, _ = _mesh(_train, cfg, mesh, dev)
    want, _, _, _ = _train(cfg, None, dev)
    _close(got, want, "sharded step")
    tok["sharded_tables"] = sum(s == SHARDED for s in specs.values())

    # the rowwise-Adagrad table optimizer: accumulators shard with tables
    cfg_ra = _cfg(n, embedding_optimizer="rowwise_adagrad",
                  embedding_learning_rate=0.03)
    got, _, _, st = _mesh(_train, cfg_ra, mesh, dev)
    acc = st["embedding"]["sum_sq"]["user_emb"]
    if acc.shape[0] != cfg_ra.model.num_users // n:
        raise AssertionError(f"accumulator not row-sharded: {acc.shape}")
    _close(got, _train(cfg_ra, None, dev)[0], "rowwise adagrad")

    # the whole step through the exchange on (2, n/2)
    got, loss2, _, _ = _mesh(_train, cfg, mesh2, dev)
    _close(got, want, "explicit exchange")

    # ShardedEmbedding's lookup and gradient
    from ncf_tpu_torch.parallel.embedding_sharding import ShardedEmbedding

    N, D = cfg.model.num_items, 16
    table = torch.arange(N * D, dtype=torch.float32, device=dev).reshape(
        N, D) / (N * D)
    emb_s = ShardedEmbedding(mesh, N, D, capacity_factor=4.0)
    shard = emb_s.shard(table).requires_grad_(True)
    ids = (torch.arange(4, device=dev) * 3 + mesh.rank) % N
    out = _mesh(emb_s.lookup, shard, ids)
    _mesh(out.sum().backward)
    if not torch.equal(out, table[ids]):
        raise AssertionError("exchange lookup differs from the gather")
    counts = torch.zeros(N, device=dev)
    for r in range(n):
        counts.index_add_(0, (torch.arange(4, device=dev) * 3 + r) % N,
                          torch.ones(4, device=dev))
    R = N // n
    want_g = counts[mesh.ici_index * R:(mesh.ici_index + 1) * R]
    if not torch.equal(shard.grad, want_g[:, None].expand(R, D)):
        raise AssertionError("exchange gradient differs")

    # the sparse update on sharded tables, with the sequence path
    cfg_sp = _cfg(n, embedding_optimizer="rowwise_adagrad",
                  embedding_learning_rate=0.01, use_sequence=True,
                  history_len=4, sparse_table_update="on")
    cfg_sp.model.num_users, cfg_sp.model.num_items = 64 * n, 32 * n
    rng = np.random.default_rng(3)
    hist = rng.integers(-1, cfg_sp.model.num_items,
                        (cfg_sp.model.num_users, 4)).astype(np.int32)
    got, _, _, st = _mesh(_train, cfg_sp, mesh2, dev, sparse=True,
                          hist=hist)
    want_sp, _, _, st1 = _train(cfg_sp, None, dev, sparse=True, hist=hist)
    _close(got, want_sp, "sparse sharded")
    acc = mesh2.all_gather(st["user_acc"], ICI_AXIS)
    _close(acc, st1["user_acc"], "sparse accumulators")
    if float(acc.sum()) <= 0:
        raise AssertionError("the sparse update touched no accumulator")

    # DeviceEvaluator over the mesh
    from ncf_tpu_torch.evals.evaluate import DeviceEvaluator, EvalSet
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel.mesh import param_shardings, shard_pytree

    model = get_model("advanced_ncf")
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    U = 2 * n + 1
    es = EvalSet(rng.integers(0, cfg.model.num_users, U).astype(np.int32),
                 rng.integers(0, cfg.model.num_items, (U, 6)).astype(
                     np.int32),
                 {k: rng.integers(0, hi, U).astype(np.int32)
                  for k, hi in (("hour", 24), ("day", 7), ("month", 12),
                                ("day_of_year", 365))})
    _, dept, cat = _consts(cfg, dev)
    one = DeviceEvaluator(model, cfg.model, es, batch_size=2,
                          item_dept=dept, item_cat=cat, device=dev)
    want_r = one.ranks(params)
    specs = param_shardings(params, mesh)
    emb.set_exchange(mesh, {k: params[k].shape[0] for k in ("user_emb",
                                                           "item_emb")})
    ev = DeviceEvaluator(model, cfg.model, es, batch_size=2,
                         item_dept=dept, item_cat=cat, device=dev, mesh=mesh)
    got_r = _mesh(ev.ranks, shard_pytree(params, specs, mesh))
    emb.clear_exchange()
    if not np.array_equal(got_r, want_r):
        raise AssertionError("sharded eval ranks differ")
    hr10 = float((got_r < 10).mean())

    _topk_checks(mesh, dev, rng)

    # the fused tower under the mesh: the kernels on the rank's rows, the
    # weight gradients summed over the ranks
    from ncf_tpu_torch.models.layers import mlp_tower_init
    from ncf_tpu_torch.ops.tower import fused_tower

    layers = mlp_tower_init(torch.Generator(device=dev).manual_seed(3), 96,
                            [256, 128, 64], dev)
    x = torch.from_numpy(rng.normal(size=(64 * n, 96)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    local = x[mesh2.rank * 64:(mesh2.rank + 1) * 64]
    w = layers[0]["dense"]["w"].requires_grad_(True)
    y = _mesh(fused_tower, layers, local, 0.0, None, True, mesh=mesh2)
    _mesh(y.square().sum().backward)
    gw = mesh2.all_reduce(w.grad, WORLD)
    w.grad = None
    y1 = fused_tower(layers, x, 0.0, None, True)
    if not torch.equal(y, y1[mesh2.rank * 64:(mesh2.rank + 1) * 64]):
        raise AssertionError("fused tower under the mesh differs")
    y1.square().sum().backward()
    _close(gw, w.grad, "fused tower weight gradient", rel=1e-4)

    # the sequence path under the mesh
    cfg_sq = _cfg(n, use_sequence=True, history_len=4)
    hist = rng.integers(-1, cfg_sq.model.num_items,
                        (cfg_sq.model.num_users, 4)).astype(np.int32)
    got, _, _, _ = _mesh(_train, cfg_sq, mesh2, dev, hist=hist)
    _close(got, _train(cfg_sq, None, dev, hist=hist)[0], "sequence mesh")

    dcn, ici = 2, n // 2
    return (f"dryrun_multichip(n={n}): ok, loss={loss:.4f}, "
            f"sharded_tables={tok['sharded_tables']}, "
            f"explicit_exchange(dcn={dcn},ici={ici})={loss2:.4f}, "
            f"rowwise_adagrad_sharded=ok, all_to_all=ok, "
            f"sparse_sharded_seq(dcn={dcn},ici={ici})=ok, "
            f"sharded_eval(hr@10={hr10:.3f})=ok, "
            f"sharded_topk=ok, sharded_topk_prepared=ok, "
            f"sharded_topk_int8=ok, fused_tower_mesh=ok, "
            f"sequence_mesh=ok")


def _topk_checks(mesh, dev, rng):
    """The item-sharded top-k: exact (B8 on the card), streaming (B5),
    prepared (B5) and int8 (B6), ids equal to one device's."""
    from ncf_tpu_torch.ops import topk
    from ncf_tpu_torch.parallel import sharded_topk as st

    n = mesh.size
    I, D = 256 * n, 16
    t = torch.from_numpy(rng.normal(size=(I, D)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=I).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(4, D)).astype(np.float32)).to(dev)
    loc_t, loc_b, num = st.shard_items(t, b, mesh)
    for impl in ("pallas", "streaming"):
        _, si = _mesh(st.sharded_topk_scores, q, loc_t, loc_b, num, mesh,
                      5, impl=impl)
        _, wi = topk.topk_scores(q, t, 5, b, impl=impl)
        if not torch.equal(si, wi):
            raise AssertionError(f"sharded topk ({impl}) ids differ")
    prep = st.shard_prepare_items(t, b, mesh, block_items=64, seg_width=32)
    _, pi = _mesh(st.sharded_topk_scores_prepared, q, prep, mesh, 5)
    _, ri = topk.topk_scores_streaming(q, t, 5, b, block_items=64,
                                       seg_width=32, seg_top=2)
    if not torch.equal(pi, ri):
        raise AssertionError("prepared sharded topk ids differ")
    prep8 = st.shard_prepare_items_int8(t, b, q, mesh, block_items=128,
                                        seg_width=32)
    v8, i8 = _mesh(st.sharded_topk_scores_prepared, q, prep8, mesh, 5,
                   seg_top=1)
    one = topk.prepare_items_int8(t, b, q, block_items=128, seg_width=32)
    rv, ri = topk.topk_scores_streaming_int8(q, one, 5, seg_top=1)
    filled = rv > -1e38
    if not (torch.equal(torch.where(filled, i8, -1),
                        torch.where(filled, ri, -1))
            and torch.equal(v8, rv)):
        raise AssertionError("int8 sharded topk differs")


def main(argv=None) -> int:
    from ncf_tpu_torch.parallel import multihost

    rank, world, store, rest = multihost.rank_args(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(rest)
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    multihost.initialize_distributed(
        init_method=f"file://{store}", world_size=world, rank=rank,
        device=ns.device, timeout_s=300)
    dev = multihost.rank_device(ns.device)
    try:
        line = _run(dev)
    finally:
        multihost.destroy()
    import json

    print("dryrun_launches: " + json.dumps(_TALLY), flush=True)
    if rank == 0:
        print(line, flush=True)
    return 0


def _cli() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args()
    print(dryrun_multichip(ns.n, ns.device))
    return 0


if __name__ == "__main__":
    sys.exit(main() if "--rank" in sys.argv else _cli())
