"""Command-line interface: train / evaluate.

Port of the ``train`` and ``evaluate`` subcommands of ``ncf_tpu/cli.py``,
with the same parsing: ``--config``, dotted ``section.key=value``
overrides, ``--log-level``, ``--resume`` for ``train``, ``--checkpoint``
and ``--protocol {sampled,full,both}`` for ``evaluate``.  ``--device``
(default ``cuda``) picks the card or, when asked, the CPU.

Usage:  python -m ncf_tpu_torch.cli <command> [--config cfg.yaml]
        [--device cuda|cpu] [section.key=value ...]
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


def cmd_train(args) -> int:
    from ncf_tpu_torch.train import Trainer

    cfg = load_config(args)
    inter = _load_interactions(cfg)
    trainer = Trainer(cfg, inter, device=args.device)
    if args.resume:
        trainer.resume()
    best = trainer.train()
    log.info("best metrics: %s", best)
    print({k: round(v, 4) for k, v in best.items()
           if isinstance(v, (int, float))})
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
    cfg = load_config(args)
    inter = _load_interactions(cfg)
    cfg.model.num_users = inter.num_users
    cfg.model.num_items = inter.num_items
    if inter.item_dept is not None:
        cfg.model.num_departments = inter.num_departments
        cfg.model.num_categories = inter.num_categories

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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
