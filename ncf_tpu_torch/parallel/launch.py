"""Local multi-process launch: N ranks training over one mesh.

The port's counterpart of ``scripts/launch_multiprocess.py``.  It starts
N fresh rank processes (``multihost.run_ranks``), each of which joins
the process group through a ``file://`` store, forms the ``(dcn, ici)``
mesh of the N ranks and trains AdvancedNCF over it from the global host
batches (``train/step.py`` under a mesh); the ranks must agree on the
loss.  ``--checkpoint-dir`` saves the run's sharded checkpoint
(``train/checkpoint.py``: each shard in its own file).

    python -m ncf_tpu_torch.parallel.launch                 # 2 ranks
    python -m ncf_tpu_torch.parallel.launch --dcn 2 --ici 2 --steps 3
    # sparse row updates + row-sharded tables + the sequence path, with a
    # sharded checkpoint at the end
    python -m ncf_tpu_torch.parallel.launch --mode sparse_seq \\
        --checkpoint-dir /tmp/mp_ckpt --out-json /tmp/mp.json
    # then one process: the same stream, its losses against the N-rank
    # run's, the sharded checkpoint restored across the topology change,
    # consolidated bit for bit, and the same top-k served from both
    python -m ncf_tpu_torch.parallel.launch --single-process \\
        --mode sparse_seq --checkpoint-dir /tmp/mp_ckpt \\
        --out-json /tmp/mp.json

The ranks run on the card (``--device``, default ``cuda``; gloo when they
share one, ``parallel/multihost.py``) or, when asked, on the CPU.  Exit
0: every rank stepped and agreed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build_cfg(mode: str, world: int):
    """The config and host tables of a run, the same in every rank and in
    the single-process check."""
    from ncf_tpu_torch.utils.config import Config

    cfg = Config()
    m, t = cfg.model, cfg.train
    m.mf_dim = m.mlp_dim = 16
    m.temporal_dim, m.mlp_hidden_dims = 8, [32, 16]
    m.compute_dtype, m.dropout, m.fused_tower = "float32", 0.0, "off"
    t.batch_size = 8 * max(world, 4)
    t.embedding_scatter = "xla"
    tables = {}
    if mode == "sparse_seq":
        # the big-vocabulary regime (entities > 4*B*S); rows divide ici
        m.num_users = m.num_items = 1024
        m.use_sequence, m.history_len = True, 4
        t.embedding_optimizer = "rowwise_adagrad"
        t.sparse_table_update = "on"
        tr = np.random.default_rng(11)
        hist = tr.integers(0, m.num_items, (m.num_users, m.history_len))
        hist[tr.random(hist.shape) < 0.3] = -1          # ragged padding
        tables["user_history"] = hist.astype(np.int32)
        tables["item_dept"] = tr.integers(
            0, m.num_departments, m.num_items).astype(np.int32)
        tables["item_cat"] = tr.integers(
            0, m.num_categories, m.num_items).astype(np.int32)
    else:
        m.num_users = m.num_items = 16 * max(world, 4)
    return cfg, tables


def _make_batches(cfg, steps: int):
    """The host stream: the same in every rank and in the check."""
    rng = np.random.default_rng(7)
    B = cfg.train.batch_size
    return [{"user_ids": rng.integers(0, cfg.model.num_users, B),
             "item_ids": rng.integers(0, cfg.model.num_items, B),
             "hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
             "month": rng.integers(0, 12, B),
             "day_of_year": rng.integers(0, 365, B)} for _ in range(steps)]


def _build_step(cfg, mode, tables, mesh, dev):
    """(model, params, opt_state, step, shardings): params and state as
    this rank's parts when ``mesh`` has several ranks."""
    import dataclasses

    import torch

    from ncf_tpu_torch.data.sampler import make_sampling_cdf
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel.mesh import (SHARDED, param_shardings,
                                             shard_pytree)
    from ncf_tpu_torch.train import optim, step as step_lib

    model = get_model(cfg.model.name)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    specs = None
    if mesh is not None:
        specs = param_shardings(params, mesh)
        rows = {k: params[k].shape[0] for k, s in specs.items()
                if s == SHARDED}
        if rows:
            emb.set_exchange(mesh, rows, 0.0)
        params = shard_pytree(params, specs, mesh)
    emb.set_scatter_impl("xla")
    cdf = make_sampling_cdf(np.ones(cfg.model.num_items), device=dev)
    consts = (cdf, tables.get("item_dept"), tables.get("item_cat"))
    if mode == "sparse_seq":
        dense_opt = optim.make_optimizer(dataclasses.replace(
            cfg.train, gradient_clip_norm=0.0), 10)
        state = step_lib.init_sparse_opt_state(dense_opt, params)
        step = step_lib.make_sparse_train_step(
            model, cfg, dense_opt, optim.make_schedule(cfg.train, 10),
            *consts, mesh=mesh, user_history=tables.get("user_history"),
            device=dev)
    else:
        opt = optim.make_optimizer(cfg.train, 10)
        state = opt.init(params)
        step = step_lib.make_train_step(model, cfg, opt, *consts,
                                        device=dev, mesh=mesh,
                                        shardings=specs)
    return model, params, state, step, specs


def _state_tree(cfg, params, state):
    from ncf_tpu_torch.train import checkpoint as ck

    t = cfg.train
    return {"params": params, "opt_state": ck.named_opt_state(
        state, t.gradient_clip_norm, t.weight_decay,
        t.embedding_weight_decay, t.embedding_learning_rate)}


def _state_specs(cfg, mode, mesh, dev):
    """The spec tree of ``_state_tree`` (from a template of global
    shapes)."""
    import torch

    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.parallel.mesh import param_shardings, state_shardings

    _, params, state, _, _ = _build_step(cfg, mode, _build_cfg(
        mode, mesh.size)[1], None, dev)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"),
                    _state_tree(cfg, params, state))
    return {"params": param_shardings(meta["params"], mesh),
            "opt_state": state_shardings(meta["opt_state"], mesh)}


def worker(args, rest) -> int:
    import torch

    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel import multihost
    from ncf_tpu_torch.parallel.mesh import WORLD, make_mesh
    from ncf_tpu_torch.train import checkpoint as ck

    rank, world, store, _ = multihost.rank_args(rest)
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    multihost.initialize_distributed(
        init_method=f"file://{store}", world_size=world, rank=rank,
        device=args.device, timeout_s=args.timeout)
    dev = multihost.rank_device(args.device)
    mesh = make_mesh(dcn=args.dcn, ici=-1)
    cfg, tables = _build_cfg(args.mode, world)
    _, params, state, step, _ = _build_step(cfg, args.mode, tables, mesh,
                                            dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    for batch in _make_batches(cfg, args.steps):
        params, state, gen, m = step(params, state, gen, batch)
        losses.append(float(m["loss"]))
    every = mesh.all_gather(torch.tensor(losses[-1:], dtype=torch.float64),
                            WORLD)
    assert bool(torch.isfinite(every).all()), f"non-finite {every}"
    assert bool((every == every[0]).all()), f"ranks disagree: {every}"
    if args.checkpoint_dir:
        specs = _state_specs(cfg, args.mode, mesh, dev)
        ck.save(args.checkpoint_dir,
                _state_tree(cfg, params, state), step=args.steps,
                mesh=mesh, shardings=specs)
    emb.clear_exchange()
    if args.out_json and multihost.is_primary():
        with open(args.out_json, "w") as f:
            json.dump({"mode": args.mode, "losses": losses, "world": world,
                       "dcn": args.dcn}, f)
    print(f"[worker {rank}/{world}] ok: primary={multihost.is_primary()} "
          f"losses={['%.4f' % v for v in losses]}", flush=True)
    multihost.destroy()
    return 0


def single_process(args) -> int:
    """The same config and stream on one process: the losses against the
    N-rank run's (``--out-json``), the N-rank checkpoint restored here,
    consolidated and restored again bit for bit, and top-k served from
    both restores."""
    import torch

    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.parallel.multihost import rank_device
    from ncf_tpu_torch.serving import ModelServer
    from ncf_tpu_torch.train import checkpoint as ck

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    dev = rank_device(args.device)
    ref = json.load(open(args.out_json)) if args.out_json else None
    world = ref["world"] if ref else args.dcn * args.ici
    cfg, tables = _build_cfg(args.mode, world)
    _, params, state, step, _ = _build_step(cfg, args.mode, tables, None,
                                            dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    for batch in _make_batches(cfg, args.steps):
        params, state, gen, m = step(params, state, gen, batch)
        losses.append(float(m["loss"]))
    print(f"[single-process] losses={['%.4f' % v for v in losses]}",
          flush=True)
    if ref:
        assert ref["mode"] == args.mode
        # f32 sums in another order (the dense gradients' all_reduce)
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5,
                                   err_msg="the N-rank trajectory")
        print(f"[single-process] trajectory matches the {world}-rank run "
              f"({len(losses)} steps)", flush=True)
    if args.checkpoint_dir:
        path = ck.find_latest(args.checkpoint_dir)
        assert path, f"no checkpoint under {args.checkpoint_dir}"
        own = _state_tree(cfg, params, state)
        template = tree_map(lambda x: x.detach().clone(), own)
        restored, _ = ck.restore(path, template, device=dev)
        for a, b in zip(_leaves(restored), _leaves(own)):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-4)
        print("[single-process] sharded checkpoint restored across the "
              "topology change; state matches this run's", flush=True)
        out = ck.consolidate(path, args.checkpoint_dir.rstrip("/")
                             + "_consolidated")
        cons, _ = ck.restore(out, template, device=dev)
        for a, b in zip(_leaves(restored), _leaves(cons)):
            np.testing.assert_array_equal(a, b)
        print("[single-process] consolidation round-trips bit-exact",
              flush=True)
        kw = {k: tables.get(k) for k in ("item_dept", "item_cat",
                                         "user_history")}
        users = np.arange(8, dtype=np.int32)
        sa, ia, _ = ModelServer(cfg, params=restored["params"], device=dev,
                                **kw).recommend_batch(users, k=5)
        sb, ib, _ = ModelServer(cfg, params=cons["params"], device=dev,
                                **kw).recommend_batch(users, k=5)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        print("[single-process] restored checkpoint serves top-k "
              "(sharded == consolidated, exact)", flush=True)
    print("single_process: OK", flush=True)
    return 0


def _leaves(tree):
    from ncf_tpu_torch.convert import params_to_numpy, tree_leaves

    return tree_leaves(params_to_numpy(tree))


def launch(args) -> int:
    from ncf_tpu_torch.parallel.multihost import run_ranks

    world = args.dcn * args.ici
    argv = ["--worker", "--dcn", str(args.dcn), "--ici", str(args.ici),
            "--steps", str(args.steps), "--mode", args.mode, "--device",
            args.device, "--timeout", str(args.timeout)]
    if args.checkpoint_dir:
        argv += ["--checkpoint-dir", args.checkpoint_dir]
    if args.out_json:
        argv += ["--out-json", args.out_json]
    try:
        outs = run_ranks("ncf_tpu_torch.parallel.launch", world, argv,
                         timeout=args.timeout, capture=True)
    except RuntimeError as err:
        print(err)
        print("launch: FAILED")
        return 1
    for r, out in enumerate(outs):
        print(f"--- rank {r} ---\n{out}", end="")
    print("launch: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true",
                    help="internal: run as one rank")
    ap.add_argument("--dcn", type=int, default=1)
    ap.add_argument("--ici", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mode", default="dense",
                    choices=["dense", "sparse_seq"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--out-json", default="")
    ap.add_argument("--single-process", action="store_true")
    args, rest = ap.parse_known_args(argv)
    if args.single_process:
        return single_process(args)
    return worker(args, rest) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
