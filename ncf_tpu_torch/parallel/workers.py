"""Rank programs that check the parallel layer against one process.

    python -m ncf_tpu_torch.parallel.workers --rank R --world N \\
        --store FILE TASK --io DIR [--dcn D] [--device cpu|cuda]

Every rank of a ``(D, N / D)`` mesh runs TASK on the inputs in
``DIR/in.npz`` and ``DIR/in.json`` (made from a seed by the caller) and
writes its outputs to ``DIR/out{R}.npz`` (and ``DIR/out{R}.json``).
``run`` starts the N ranks (``multihost.run_ranks``).  The tasks drive
the exchange, the item-sharded top-k, the sharded sparse update, the
mesh training steps, the evaluators, the ``Trainer`` and sharded
checkpoints; the caller holds the outputs to the JAX package's mesh
functions and to the port's one-process answers.  Nothing here imports
JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ncf_tpu_torch.convert import params_to_numpy, tree_map
from ncf_tpu_torch.parallel import multihost
from ncf_tpu_torch.parallel.mesh import (ICI_AXIS, Mesh, gather_pytree,
                                         make_mesh, param_shardings,
                                         rows_of, shard_pytree)

MODULE = "ncf_tpu_torch.parallel.workers"


def run(task: str, world: int, io: str, dcn: int = 1, device: str = "cuda",
        timeout: float = 240.0, local_world=None) -> list:
    """Run ``task`` on ``world`` ranks, joined through the store file
    ``io/store``; returns each rank's output."""
    store = os.path.join(io, "store")
    if os.path.exists(store):
        os.remove(store)
    return multihost.run_ranks(
        MODULE, world, [task, "--io", io, "--dcn", str(dcn), "--device",
                        device], store=store, timeout=timeout, capture=True,
        local_world=local_world)


# ---------------------------------------------------------------- i/o

def save_inputs(io: str, arrays: Optional[Dict[str, Any]] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(io, exist_ok=True)
    np.savez(os.path.join(io, "in.npz"), **(arrays or {}))
    with open(os.path.join(io, "in.json"), "w") as f:
        json.dump(meta or {}, f)


def load_outputs(io: str, rank: int):
    arrs = dict(np.load(os.path.join(io, f"out{rank}.npz")))
    path = os.path.join(io, f"out{rank}.json")
    meta = json.load(open(path)) if os.path.exists(path) else {}
    return arrs, meta


def _inputs(io: str):
    arrs = dict(np.load(os.path.join(io, "in.npz"), allow_pickle=False))
    with open(os.path.join(io, "in.json")) as f:
        return arrs, json.load(f)


def _outputs(io: str, rank: int, arrays: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None) -> None:
    out = {k: (v.detach().cpu().float().numpy()
               if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
               else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v)) for k, v in arrays.items()}
    np.savez(os.path.join(io, f"out{rank}.npz"), **out)
    if meta is not None:
        with open(os.path.join(io, f"out{rank}.json"), "w") as f:
            json.dump(meta, f)


def flatten(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """``{prefix.path: array}`` for every leaf (the checkpoint names)."""
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    return {f"{prefix}.{p}": np.asarray(v)
            for p, v in _leaves_with_path(params_to_numpy(tree))}


def unflatten(template: Any, flat: Dict[str, np.ndarray], prefix: str,
              device) -> Any:
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path, _rebuild

    leaves = {p: torch.from_numpy(np.array(flat[f"{prefix}.{p}"])).to(device)
              for p, _ in _leaves_with_path(template)}
    return _rebuild(template, leaves)


def _cfg(d: Dict[str, Any]):
    from ncf_tpu_torch.utils.config import Config

    return Config.from_dict(d)


def _t(x, dev):
    return torch.from_numpy(np.array(x)).to(dev)


# -------------------------------------------------------------- tasks

def task_exchange(mesh: Mesh, io: str, dev) -> None:
    """The exchange's lookup and table gradient, ShardedEmbedding, and
    the routing by table name against a replicated table of the shard's
    shape."""
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel.embedding_sharding import (ShardedEmbedding,
                                                           exchange_lookup)

    a, meta = _inputs(io)
    r = mesh.rank
    N = a["table"].shape[0]
    cf = float(meta.get("capacity_factor", 0.0))
    shard = _t(a["table"][rows_of(mesh, N)], dev).requires_grad_(True)
    ids = _t(a["ids"][r], dev)
    out = exchange_lookup(mesh, shard, ids, cf)
    out.backward(_t(a["g"][r], dev))
    se = ShardedEmbedding(mesh, N, a["table"].shape[1], capacity_factor=4.0)
    shard2 = se.shard(_t(a["table"], dev)).requires_grad_(True)
    out2 = se.lookup(shard2, ids.reshape(-1))
    out2.backward(_t(a["g"][r], dev).reshape(out2.shape))
    emb.set_exchange(mesh, {"user_emb": N}, cf)
    try:
        routed = emb.embedding_lookup(shard.detach(), ids, "user_emb")
        small = _t(a["small"], dev)          # replicated, the shard's shape
        plain = emb.embedding_lookup(small, _t(a["small_ids"][r], dev),
                                     "temporal")
        unnamed = emb.embedding_lookup(small, _t(a["small_ids"][r], dev))
    finally:
        emb.clear_exchange()
    _outputs(io, r, {"out": out, "grad": shard.grad, "se_out": out2,
                     "se_grad": shard2.grad, "routed": routed,
                     "plain": plain, "unnamed": unnamed})


def task_topk(mesh: Mesh, io: str, dev) -> None:
    """``sharded_topk_scores`` at several impls and the prepared f32 and
    int8 tiers."""
    from ncf_tpu_torch.parallel import sharded_topk as st

    a, meta = _inputs(io)
    items, bias = _t(a["items"], dev), _t(a["bias"], dev)
    q = _t(a["queries"], dev)
    k = int(meta["k"])
    out = {}
    t_loc, b_loc, n = st.shard_items(items, bias, mesh)
    for impl in meta.get("impls", ["dense"]):
        v, i = st.sharded_topk_scores(q, t_loc, b_loc, n, mesh, k, impl=impl)
        out[f"{impl}_v"], out[f"{impl}_i"] = v, i
    bi, sw = int(meta["block_items"]), int(meta["seg_width"])
    prep = st.shard_prepare_items(items, bias, mesh, block_items=bi,
                                  seg_width=sw)
    out["prep_v"], out["prep_i"] = st.sharded_topk_scores_prepared(
        q, prep, mesh, k, seg_top=2)
    prep8 = st.shard_prepare_items_int8(
        items, bias, _t(a["qsample"], dev), mesh, block_items=bi,
        seg_width=sw)
    out["int8_v"], out["int8_i"] = st.sharded_topk_scores_prepared(
        q, prep8, mesh, k, seg_top=int(meta.get("int8_seg_top", 1)))
    _outputs(io, mesh.rank, out)


def task_sparse_update(mesh: Mesh, io: str, dev) -> None:
    """``_route_combine`` and ``sharded_sparse_rowwise_adagrad_update``
    with given per-occurrence gradients, once for each clip of
    ``meta["clips"]`` from the same state."""
    from ncf_tpu_torch.train import sparse_sharded as ss

    a, meta = _inputs(io)
    r = mesh.rank

    def state():
        tabs, accs, ids, gs = [], [], [], []
        for name in ("user", "item"):
            sl = rows_of(mesh, a[f"{name}_table"].shape[0])
            tabs.append(_t(a[f"{name}_table"][sl], dev))
            accs.append(_t(a[f"{name}_acc"][sl], dev))
            ids.append(_t(a[f"{name}_ids"][r], dev))
            gs.append(_t(a[f"{name}_g"][r], dev))
        return tabs, accs, ids, gs

    out = {}
    tabs, _, ids, gs = state()
    for name, t, i, g in zip(("user", "item"), tabs, ids, gs):
        rep, tot = ss._route_combine(mesh, i, g, t.shape[0], i.numel())
        out[f"{name}_rep"], out[f"{name}_tot"] = rep, tot
    dense_sq = meta.get("dense_sq")
    for c, clip in enumerate(meta["clips"]):
        tabs, accs, ids, gs = state()
        tabs, accs, gscale = ss.sharded_sparse_rowwise_adagrad_update(
            mesh, tabs, accs, ids, gs, float(meta["lr"]), float(meta["eps"]),
            float(meta["weight_decay"]), clip=float(clip),
            dense_sq=None if dense_sq is None
            else torch.tensor(dense_sq, dtype=torch.float32, device=dev))
        out.update({f"c{c}_user_table": tabs[0], f"c{c}_item_table": tabs[1],
                    f"c{c}_user_acc": accs[0], f"c{c}_item_acc": accs[1],
                    f"c{c}_gscale": gscale})
    _outputs(io, r, out)


def _register(mesh, params, specs, cfg) -> None:
    from ncf_tpu_torch.ops import embedding as emb

    rows = {k: params[k].shape[0] for k, s in specs.items() if s == ICI_AXIS}
    if rows:
        emb.set_exchange(mesh, rows, cfg.mesh.exchange_capacity_factor)


def task_step(mesh: Mesh, io: str, dev) -> None:
    """K mesh training steps (dense or sparse) from given params with the
    given global batches and negatives; rank 0 writes the gathered state
    and the metrics."""
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.train import optim, step as step_lib

    a, meta = _inputs(io)
    cfg = _cfg(meta["config"])
    model = get_model(cfg.model.name)
    template = model.init(torch.Generator(), cfg.model, device="meta")
    full = unflatten(template, a, "params", dev)
    specs = param_shardings(full, mesh, cfg.mesh.shard_embeddings)
    params = shard_pytree(full, specs, mesh)
    _register(mesh, full, specs, cfg)
    consts = {k: (a[k] if k in a else None)
              for k in ("cdf", "dept", "cat", "user_history")}
    K = int(meta["steps"])
    emb.set_scatter_impl(*meta.get("scatter", ("auto", "split")))
    if meta["mode"] == "sparse":
        import dataclasses

        dense_opt = optim.make_optimizer(dataclasses.replace(
            cfg.train, gradient_clip_norm=0.0), K)
        sched = optim.make_schedule(cfg.train, K)
        state = step_lib.init_sparse_opt_state(dense_opt, params)
        fn = step_lib.make_sparse_train_step(
            model, cfg, dense_opt, sched, consts["cdf"], consts["dept"],
            consts["cat"], mesh=mesh, user_history=consts["user_history"],
            device=dev)
    else:
        opt = optim.make_optimizer(cfg.train, K)
        state = opt.init(params)
        fn = step_lib.make_train_step(
            model, cfg, opt, consts["cdf"], consts["dept"], consts["cat"],
            consts["user_history"], device=dev, mesh=mesh, shardings=specs)
    gen = torch.Generator(device=dev).manual_seed(int(meta.get("seed", 0)))
    metrics = []
    for k in range(K):
        batch = {c: a[f"batch{k}.{c}"] for c in meta["columns"]}
        negs = a[f"negs{k}"] if f"negs{k}" in a else None
        params, state, gen, m = fn(params, state, gen, batch, negs)
        metrics.append({n: float(v) for n, v in m.items()})
    emb.clear_exchange()
    out = flatten(gather_pytree(params, specs, mesh), "params")
    if meta["mode"] == "sparse":
        for name in ("user_acc", "item_acc"):
            acc = state[name]
            if specs[name.replace("_acc", "_emb")] == ICI_AXIS:
                acc = mesh.all_gather(acc, ICI_AXIS)
            out[name] = acc.cpu().numpy()
    else:
        for mom in ("mu", "nu"):
            out.update(flatten(gather_pytree(state[mom], specs, mesh), mom))
    if mesh.rank == 0:
        _outputs(io, 0, out, {"metrics": metrics})


def task_eval(mesh: Mesh, io: str, dev) -> None:
    """``DeviceEvaluator`` and ``FullCatalogEvaluator`` under the mesh on
    given params, lookups through the exchange."""
    from ncf_tpu_torch.evals.evaluate import DeviceEvaluator, EvalSet
    from ncf_tpu_torch.evals.full_eval import FullCatalogEvaluator
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding as emb

    a, meta = _inputs(io)
    cfg = _cfg(meta["config"])
    model = get_model(cfg.model.name)
    template = model.init(torch.Generator(), cfg.model, device="meta")
    full = unflatten(template, a, "params", dev)
    specs = param_shardings(full, mesh, cfg.mesh.shard_embeddings)
    params = shard_pytree(full, specs, mesh)
    _register(mesh, full, specs, cfg)
    es = EvalSet(a["users"], a["candidates"],
                 {k: a[f"t.{k}"] for k in ("hour", "day", "month",
                                           "day_of_year")})
    ev = DeviceEvaluator(model, cfg.model, es, batch_size=int(meta["B"]),
                         item_dept=a["dept"], item_cat=a["cat"], device=dev,
                         mesh=mesh)
    out = {"sampled": ev.ranks(params)}
    inter = _interactions(meta)
    fe = FullCatalogEvaluator(
        cfg.model, inter, a["users"], a["candidates"][:, 0],
        item_dept=a["dept"], item_cat=a["cat"], user_block=int(meta["B"]),
        item_block=int(meta.get("item_block", 64)), device=dev, mesh=mesh,
        shardings=specs)
    out["full"] = fe.ranks(params)
    emb.clear_exchange()
    _outputs(io, mesh.rank, out)


def _interactions(meta):
    from ncf_tpu_torch.data import generate_interactions

    return generate_interactions(**meta["interactions"])


def task_trainer(mesh: Mesh, io: str, dev) -> None:
    """The ``Trainer`` over the mesh: one epoch (its mid-epoch checkpoints
    as the config says) and an epoch checkpoint, ``validate`` on its own
    params and on given ones, and a second ``Trainer`` resuming a given
    checkpoint to the end of its epoch."""
    from ncf_tpu_torch.train.trainer import Trainer

    a, meta = _inputs(io)
    cfg = _cfg(meta["config"])
    inter = _interactions(meta)
    t = Trainer(cfg, inter, mesh=mesh, device=dev)
    t.train_epoch(0)
    t.save_checkpoint(0, {"epoch_end": 1.0})
    res = {"validate": t.validate(0), "step": t.global_step}
    out = flatten(gather_pytree(t.params, t.shardings, mesh), "params")
    if any(k.startswith("given.") for k in a):
        given = unflatten(_meta_like(t), a, "given", dev)
        t.params = shard_pytree(given, t.shardings, mesh)
        res["validate_given"] = t.validate(0)
    if meta.get("resume_dir"):
        t2 = Trainer(_cfg(meta["config"]), inter, mesh=mesh, device=dev)
        t2.resume(meta["resume_dir"])
        t2.train_epoch(t2.start_epoch)
        out.update(flatten(gather_pytree(t2.params, t2.shardings, mesh),
                           "resumed"))
    if mesh.rank == 0:
        _outputs(io, 0, out, res)


def _meta_like(t):
    """A template of the Trainer's whole params (global shapes)."""
    from ncf_tpu_torch.models import get_model

    return get_model(t.cfg.model.name).init(
        torch.Generator(), t.cfg.model, device="meta")


def task_ckpt_save(mesh: Mesh, io: str, dev) -> None:
    """Save given params and Adam moments as this mesh's sharded
    checkpoint."""
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import checkpoint as ck
    from ncf_tpu_torch.parallel.mesh import state_shardings

    a, meta = _inputs(io)
    cfg = _cfg(meta["config"])
    template = get_model(cfg.model.name).init(torch.Generator(), cfg.model,
                                              device="meta")
    full = unflatten(template, a, "params", dev)
    state = {"count": torch.tensor(int(meta["count"]), dtype=torch.int32),
             "mu": unflatten(template, a, "mu", dev),
             "nu": unflatten(template, a, "nu", dev)}
    named = ck.named_opt_state(state, cfg.train.gradient_clip_norm,
                               cfg.train.weight_decay)
    tree = {"params": full, "opt_state": named}
    specs = {"params": param_shardings(full, mesh),
             "opt_state": state_shardings(named, mesh)}
    ck.save(meta["dir"], shard_pytree(tree, specs, mesh),
            step=int(meta["step"]), epoch=0, mesh=mesh, shardings=specs)


def task_ckpt_restore(mesh: Mesh, io: str, dev) -> None:
    """Restore a checkpoint onto this mesh; each rank writes its parts."""
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import checkpoint as ck
    from ncf_tpu_torch.train import optim
    from ncf_tpu_torch.parallel.mesh import state_shardings

    a, meta = _inputs(io)
    cfg = _cfg(meta["config"])
    template = get_model(cfg.model.name).init(torch.Generator(), cfg.model,
                                              device="meta")
    named = ck.named_opt_state(optim.make_optimizer(cfg.train).init(template),
                               cfg.train.gradient_clip_norm,
                               cfg.train.weight_decay)
    specs = {"params": param_shardings(template, mesh),
             "opt_state": state_shardings(named, mesh)}
    local = shard_pytree({"params": template, "opt_state": named}, specs,
                         mesh)
    local = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype), local)
    state, _ = ck.restore(meta["dir"], local, device=dev, mesh=mesh,
                          shardings=specs)
    _outputs(io, mesh.rank, {**flatten(state["params"], "params"),
                             **flatten(state["opt_state"], "opt")})


def task_mesh_shape(mesh: Mesh, io: str, dev) -> None:
    """The mesh ``Config.build_mesh`` makes of a config file under
    ``mesh.enable: on``, on these ranks and hosts."""
    from ncf_tpu_torch.utils.config import Config

    _, meta = _inputs(io)
    cfg = Config.from_yaml(meta["config_path"])
    cfg.mesh.enable = "on"
    built = cfg.build_mesh()
    _outputs(io, mesh.rank, {}, {"shape": built.shape, "rank": built.rank,
                                 "ici_index": built.ici_index,
                                 "dcn_index": built.dcn_index})


TASKS = {"exchange": task_exchange, "mesh_shape": task_mesh_shape, "topk": task_topk,
         "sparse_update": task_sparse_update, "step": task_step,
         "eval": task_eval, "trainer": task_trainer,
         "ckpt_save": task_ckpt_save, "ckpt_restore": task_ckpt_restore}


def main(argv=None) -> int:
    import argparse

    rank, world, store, rest = multihost.rank_args(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("--io", required=True)
    ap.add_argument("--dcn", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(rest)
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    multihost.initialize_distributed(
        init_method=f"file://{store}", world_size=world, rank=rank,
        device=ns.device, timeout_s=120)
    dev = multihost.rank_device(ns.device)
    mesh = make_mesh(dcn=ns.dcn, ici=-1)
    try:
        TASKS[ns.task](mesh, ns.io, dev)
    finally:
        multihost.destroy()
    print(f"[rank {rank}/{world}] {ns.task} took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
