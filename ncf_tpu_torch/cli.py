"""Command-line interface: train / evaluate / score / serve / export /
datagen / consolidate / demo / doctor.

Port of ``ncf_tpu/cli.py`` with the same parsing: ``--config``, dotted
``section.key=value`` overrides, ``--log-level`` and each subcommand's
own flags (``--resume`` for ``train``; ``--checkpoint`` and ``--protocol
{sampled,full,both}`` for ``evaluate``; ``--num-users``, ``--top-k`` and
``--output`` for ``score``; ``--port`` for ``serve``; ``--users`` for
``export``; ``--customer`` and ``--hour`` for ``demo``; ``doctor`` takes
only the common flags).  ``--device`` (default ``cuda``) picks the card
or, when asked, the CPU.

Usage:  python -m ncf_tpu_torch.cli <command> [--config cfg.yaml]
        [--device cuda|cpu] [section.key=value ...]

``train`` over a mesh runs one process a rank:

    python -m torch.distributed.run --nproc-per-node N \
        -m ncf_tpu_torch.cli train --config cfg.yaml

Each rank joins the process group from torchrun's environment
(``parallel/multihost.py``: NCCL when every rank has a card of its own,
gloo when ranks share one) and works on the card ``LOCAL_RANK mod
cards``.  Several ranks always train over one mesh of them, shaped by
``mesh.dcn_axis``/``mesh.ici_axis`` (a multi-process launch builds its
own mesh, as the reference's ``MeshConfig.enable`` comment says);
``mesh.enable`` decides for one process (``Config.build_mesh``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

import numpy as np

from ncf_tpu_torch.utils.config import Config, setup_logging

log = logging.getLogger(__name__)


def shipped_demo_checkpoint() -> Optional[str]:
    """Path of the committed demo checkpoint (``demo/checkpoint`` at the
    repo root, built by ``scripts/make_demo_checkpoint.py``) if present:
    ``demo`` works on a fresh clone without a training run."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = os.path.join(root, "demo", "checkpoint")
    if os.path.exists(os.path.join(p, "manifest.json")):
        return p
    return None


def load_config(args) -> Config:
    cfg = Config.from_yaml(args.config) if args.config else Config()
    cfg.apply_overrides(args.overrides or [])
    return cfg


def _load_interactions(cfg: Config):
    from ncf_tpu_torch.data import Interactions, generate_interactions
    from ncf_tpu_torch.data import movielens

    d = cfg.data
    if d.dataset == "movielens":
        if not d.path:
            raise SystemExit("data.path required for dataset=movielens")
        return movielens.load(d.path)
    if d.dataset == "synthetic":
        return generate_interactions(
            num_users=d.synthetic_users, num_items=d.synthetic_items,
            num_days=d.synthetic_days,
            avg_txns_per_user=d.synthetic_avg_txns_per_user,
            seed=d.synthetic_seed)
    if d.dataset == "jsonl":
        users, items, ts, amounts = [], [], [], []
        with open(d.path) as f:
            for line in f:
                rec = json.loads(line)
                users.append(rec["user_id"])
                items.append(rec["item_id"])
                ts.append(rec["timestamp"])
                amounts.append(rec.get("amount", 1.0))
        return Interactions.from_raw(
            np.asarray(users), np.asarray(items), np.asarray(ts),
            np.asarray(amounts, np.float32))
    raise SystemExit(f"unknown dataset {d.dataset!r}")


def _sized_config(args):
    """(config, interactions): the config's model sized to the log."""
    cfg = load_config(args)
    inter = _load_interactions(cfg)
    cfg.model.num_users = inter.num_users
    cfg.model.num_items = inter.num_items
    if inter.item_dept is not None:
        cfg.model.num_departments = inter.num_departments
        cfg.model.num_categories = inter.num_categories
    return cfg, inter


def cmd_train(args) -> int:
    from ncf_tpu_torch.train import Trainer

    from ncf_tpu_torch.parallel import make_mesh, multihost

    cfg = load_config(args)
    _, world = multihost.initialize_distributed(device=args.device)
    device = multihost.rank_device(args.device)
    inter = _load_interactions(cfg)
    mesh = (make_mesh(dcn=cfg.mesh.dcn_axis, ici=cfg.mesh.ici_axis)
            if world > 1 else cfg.build_mesh())
    if mesh is not None:
        log.info("training over mesh %s", mesh.shape)
    trainer = Trainer(cfg, inter, mesh=mesh, device=device)
    if args.resume:
        trainer.resume()
    best = trainer.train()
    log.info("best metrics: %s", best)
    if multihost.is_primary():
        print({k: round(v, 4) for k, v in best.items()
               if isinstance(v, (int, float))})
    multihost.destroy()
    return 0


def cmd_evaluate(args) -> int:
    import torch

    from ncf_tpu_torch.evals import (DeviceEvaluator, EvalSet,
                                     FullCatalogEvaluator, full_ranks_naive,
                                     metrics_from_ranks, sample_eval_users)
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import checkpoint as ckpt_lib
    from ncf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg, inter = _sized_config(args)

    model = get_model(cfg.model.name)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    ckpt = (args.checkpoint
            or ckpt_lib.find_best(cfg.train.checkpoint_dir)
            or ckpt_lib.find_latest(cfg.train.checkpoint_dir))
    if ckpt:
        state, _ = ckpt_lib.restore(ckpt, {"params": params}, device=dev)
        params = state["params"]
        log.info("evaluating %s", ckpt)
    else:
        log.warning("no checkpoint found; evaluating random params")

    loo_train, eval_users, eval_items = inter.leave_one_out()
    eval_users, eval_items = sample_eval_users(
        eval_users, eval_items, cfg.data.eval_user_sample,
        seed=cfg.train.seed + 777)
    eval_set = EvalSet.build(inter, eval_users, eval_items,
                             cfg.data.num_eval_negatives, cfg.train.seed)
    eval_history = (loo_train.recent_history(cfg.model.history_len)
                    if cfg.model.use_sequence else None)
    protocol = args.protocol or cfg.data.eval_protocol
    out = {}
    if protocol in ("sampled", "both"):
        evaluator = DeviceEvaluator(
            model, cfg.model, eval_set,
            batch_size=cfg.data.eval_batch_size,
            item_dept=inter.item_dept, item_cat=inter.item_cat,
            user_history=eval_history, device=dev)
        out["sampled"] = evaluator(params)
    if protocol in ("full", "both"):
        if cfg.model.name == "advanced_ncf":
            full_ev = FullCatalogEvaluator(
                cfg.model, inter, eval_users, eval_items,
                user_history=eval_history,
                item_dept=inter.item_dept, item_cat=inter.item_cat,
                user_block=cfg.data.full_eval_user_block,
                item_block=cfg.data.full_eval_item_block, device=dev)
            out["full"] = full_ev(params)
        else:
            out["full"] = metrics_from_ranks(full_ranks_naive(
                model, params, cfg.model, inter, eval_users, eval_items,
                user_history=eval_history, item_dept=inter.item_dept,
                item_cat=inter.item_cat, device=dev))
    for proto, metrics in out.items():
        print(proto, {k: round(v, 4) for k, v in metrics.items()})
    return 0


def _server(cfg, inter, args, what: str, fallback=None):
    """``ModelServer`` from ``--checkpoint`` or the configured directory;
    without one, from ``fallback()`` or random params."""
    from ncf_tpu_torch.serving import ModelServer

    kw = {"item_dept": inter.item_dept, "item_cat": inter.item_cat,
          "device": args.device}
    try:
        return ModelServer.from_checkpoint(cfg, args.checkpoint, **kw)
    except FileNotFoundError:
        server = fallback(kw) if fallback is not None else None
        if server is None:
            log.warning("no checkpoint; %s with random params", what)
            server = ModelServer(cfg, **kw)
        return server


def cmd_score(args) -> int:
    """Batch scorer writing a predictions CSV."""
    cfg, inter = _sized_config(args)
    server = _server(cfg, inter, args, "scoring")
    try:
        rng = np.random.default_rng(0)
        users = rng.choice(inter.num_users,
                           size=min(args.num_users, inter.num_users),
                           replace=False)
        scores, items, ms = server.recommend_batch(users, k=args.top_k)
    finally:
        server.close()
    out = args.output or "predictions.csv"
    with open(out, "w") as f:
        f.write("customer_id,product_id,rank,score\n")
        for r, u in enumerate(users):
            for c in range(args.top_k):
                f.write(f"{u},{items[r, c]},{c + 1},{scores[r, c]:.6f}\n")
    log.info("wrote %s (%d users x top-%d in %.1f ms)",
             out, len(users), args.top_k, ms)
    print(f"wrote {out}")
    return 0


def cmd_serve(args) -> int:
    """The HTTP API over the checkpoint's model, with the feature store
    of the configured log."""
    from ncf_tpu_torch.api import RecommendationAPI, serve
    from ncf_tpu_torch.serving import FeatureProcessor, FeatureStore

    cfg, inter = _sized_config(args)
    server = _server(cfg, inter, args, "serving")
    try:
        api = RecommendationAPI(server, FeatureProcessor(FeatureStore(inter)))
        serve(api, host=cfg.serving.host, port=args.port or cfg.serving.port)
    finally:
        server.close()
    return 0


def cmd_export(args) -> int:
    """Product (and with ``--users`` user) embeddings as JSONL."""
    import torch

    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.serving import (export_product_embeddings,
                                       export_user_embeddings)
    from ncf_tpu_torch.train import checkpoint as ckpt_lib
    from ncf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg, inter = _sized_config(args)
    model = get_model(cfg.model.name)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    ckpt = (args.checkpoint
            or ckpt_lib.find_best(cfg.train.checkpoint_dir)
            or ckpt_lib.find_latest(cfg.train.checkpoint_dir))
    if ckpt:
        state, _ = ckpt_lib.restore(ckpt, {"params": params}, device=dev)
        params = state["params"]
    path = export_product_embeddings(
        params, cfg, args.output or "product_embeddings.jsonl",
        inter.item_dept, inter.item_cat, device=dev)
    print(f"wrote {path}")
    if args.users:
        upath = export_user_embeddings(
            params, cfg, args.users_output or "user_embeddings.jsonl",
            device=dev)
        print(f"wrote {upath}")
    return 0


def cmd_datagen(args) -> int:
    """The configured interaction log as newline JSON."""
    from ncf_tpu_torch.serving.export import export_interactions_jsonl

    cfg = load_config(args)
    inter = _load_interactions(cfg)
    out = args.output or "interactions.jsonl"
    export_interactions_jsonl(inter, out)
    print(f"wrote {out}: {len(inter)} interactions, "
          f"{inter.num_users} users x {inter.num_items} items")
    return 0


def cmd_consolidate(args) -> int:
    """Merge a (sharded) checkpoint into single-file dense leaves for
    serving export (host only)."""
    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    cfg = load_config(args)
    ckpt = (args.checkpoint
            or ckpt_lib.find_best(cfg.train.checkpoint_dir)
            or ckpt_lib.find_latest(cfg.train.checkpoint_dir))
    if ckpt is None:
        raise SystemExit(f"no checkpoint under {cfg.train.checkpoint_dir}")
    out = ckpt_lib.consolidate(ckpt, args.output or (ckpt + "_consolidated"))
    print(f"consolidated {ckpt} -> {out}")
    return 0


def cmd_demo(args) -> int:
    """Terminal demo: top-k for a customer, optionally under the
    hour-of-day modulation of ``score_items_with_hour``, plus the model
    intelligence dashboard."""
    import torch

    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.serving import (FeatureProcessor, FeatureStore,
                                       ModelServer)
    from ncf_tpu_torch.serving.intelligence import intelligence_report

    def shipped(kw):
        # the committed demo checkpoint fits only the default synthetic
        # config's shapes
        path = shipped_demo_checkpoint()
        if path:
            try:
                server = ModelServer.from_checkpoint(cfg, path, **kw)
                log.info("using shipped demo checkpoint: %s", path)
                return server
            except (KeyError, ValueError) as e:
                log.warning("shipped demo checkpoint unusable (%s)", e)
        return None

    cfg, inter = _sized_config(args)
    server = _server(cfg, inter, args, "demo", fallback=shipped)
    try:
        proc = FeatureProcessor(FeatureStore(inter))
        uid = args.customer

        scores, items, ms = server.recommend(uid, k=args.top_k)
        print(f"\nTop-{args.top_k} for customer {uid} "
              f"({ms:.1f} ms inference):")
        for rank, rec in enumerate(proc.enrich_products(items, scores)):
            print(f"  #{rank + 1:>2} {rec['name']:<28} "
                  f"{rec['category'] or '?':<4} "
                  f"score={rec['score']:.4f}  ({rec['explanation']})")

        if args.hour is not None and cfg.model.name == "advanced_ncf":
            model = get_model(cfg.model.name)
            n, dev = cfg.model.num_items, server.device
            with torch.no_grad():
                s = model.score_items_with_hour(
                    server.params, cfg.model,
                    torch.full((n,), uid, dtype=torch.long, device=dev),
                    torch.arange(n, dtype=torch.long, device=dev),
                    torch.full((n,), args.hour, dtype=torch.long,
                               device=dev)).cpu().numpy()
            top = np.argsort(-s)[: args.top_k]
            print(f"\nWith hour-of-day={args.hour} modulation "
                  f"(forward_simple semantics):")
            for rank, item in enumerate(top):
                print(f"  #{rank + 1:>2} item {int(item):<6} "
                      f"score={s[item]:.4f}")

        report = intelligence_report(
            server.params, cfg.model, uid, scores, items)
    finally:
        server.close()
    print("\nModel intelligence:")
    print(f"  component importance: MF={report['component_importance']['mf']:.2f}"
          f" MLP={report['component_importance']['mlp']:.2f}")
    print(f"  attention heads (std-importance): "
          f"{report['attention_head_importance']}")
    print(f"  confidence: mean={report['confidence']['mean']:.3f} "
          f"std={report['confidence']['std']:.3f}")
    return 0


def cmd_doctor(args) -> int:
    """Environment validator (reference: scripts/0. setup/
    validate_setup.py:17-30) — the cards and their compute capability,
    the kernels built and one launched, the configured model's memory
    against the card, mesh fit, checkpoint-dir writability, native
    loader, redis reachability."""
    from ncf_tpu_torch.utils import doctor

    cfg = load_config(args)
    return doctor.run(cfg, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ncf_tpu_torch",
        description="neural collaborative filtering on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", help="YAML config path")
        sp.add_argument("overrides", nargs="*",
                        help="section.key=value overrides")
        sp.add_argument("--log-level", default="INFO")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")

    sp = sub.add_parser("train", help="train a model")
    common(sp)
    sp.add_argument("--resume", action="store_true",
                    help="resume from latest checkpoint")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("evaluate", help="leave-one-out ranking eval")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--protocol", default="",
                    choices=["", "sampled", "full", "both"],
                    help="override data.eval_protocol; 'both' reports the "
                         "sampled and exact full-catalog metrics side by "
                         "side")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("score", help="batch-score users to CSV")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--num-users", type=int, default=100)
    sp.add_argument("--top-k", type=int, default=10)
    sp.add_argument("--output")
    sp.set_defaults(fn=cmd_score)

    sp = sub.add_parser("serve", help="run the HTTP API")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--port", type=int)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("export", help="export embeddings JSONL")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--output")
    sp.add_argument("--users", action="store_true")
    sp.add_argument("--users-output")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("datagen", help="generate synthetic interactions")
    common(sp)
    sp.add_argument("--output")
    sp.set_defaults(fn=cmd_datagen)

    sp = sub.add_parser("consolidate",
                        help="merge sharded checkpoint for serving")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--output")
    sp.set_defaults(fn=cmd_consolidate)

    sp = sub.add_parser("demo", help="terminal demo: top-k + intelligence")
    common(sp)
    sp.add_argument("--checkpoint")
    sp.add_argument("--customer", type=int, default=0)
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--hour", type=int, default=None)
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser(
        "doctor",
        help="validate the environment: cards, kernel build and launch, "
             "memory budget vs config, mesh fit, checkpoint-dir "
             "writability, native loader, redis")
    common(sp)
    sp.set_defaults(fn=cmd_doctor)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from ncf_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    resolve_device(args.device)     # every subcommand: the card, or raise
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
