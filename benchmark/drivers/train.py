"""The training driver: the port's training step, one step a call.

Set-up makes the weights and the item taxonomy from the seed and the
mix's inputs: an interaction log fed through
``data/pipeline.py::DeviceEpochPipeline`` (epochs built on the card and
rebuilt as the window crosses them), or a pool of drawn id batches
cycled through.  It builds the step as ``train/trainer.py`` does for the
configuration (``train/step.py::make_train_step``, or
``make_sparse_train_step`` where the sparse table update applies), then
drives that same step object through the mix's checked steps, which
build every kernel, and hands it to the window.  After the first checked
step it reads the gradient each leaf gave the optimizer from the
optimizer's state, and after the last the norm of each leaf's change
from the seeded weights (made again block by block, so no second copy of
a table is held).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import sys
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import spec, weights
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.traffic import generate

B1 = ref_train.B1


def change_norms(params, m, seed: int):
    """Each leaf's norm of its change from the seeded weights, and each
    table's squared change a row (f32, on the host), tables a block of
    rows at a time."""
    dev = params["item_emb"].device
    start = dict(weights.leaves(weights.layout(m)))
    out, rows = {}, {}
    for path, cur in weights.leaves(params):
        spec_ = start[path]
        if spec_[0] == "table":
            parts = []
            for b in range(weights.table_blocks(spec_[1])):
                lo = b * weights.TABLE_BLOCK
                init = weights.table_block(seed, path, spec_[1], b, dev)
                parts.append((cur[lo:lo + init.shape[0]].float() - init)
                             .square().sum(1).cpu())
                del init
            rows[path] = torch.cat(parts)
            out[path] = float(rows[path].double().sum()) ** 0.5
        else:
            init = weights.leaf_maker(seed, dev)(path, spec_)
            out[path] = float((cur.float() - init).norm())
    return out, rows


class Driver:
    unit_metric = "train_examples_per_s"
    latency_metric = None

    def __init__(self, cell: spec.Cell, seed: int, device,
                 overrides: Optional[Dict] = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        ov = overrides or {}
        self.mix = dict(cell.traffic, **ov.get("traffic", {}))
        self.B = int(self.mix["batch_size"])
        self.cfg = spec.port_config(cell.config, {
            "model": ov.get("model", {}),
            "train": {"batch_size": self.B}})
        self.pipe_seed = generate.sub_seed(self.seed, "pipeline") % (2 ** 31)
        self.sparse = self._sparse()

    def _sparse(self) -> bool:
        """Whether the Trainer would take the sparse table update for this
        configuration (``train/trainer.py``'s rule)."""
        from ncf_tpu_torch.train.step import sparse_mode_available

        mode = self.cfg.train.sparse_table_update
        return mode == "on" or (mode == "auto"
                                and sparse_mode_available(self.cfg))

    # ------------------------------------------------------------ inputs

    def inputs(self) -> Dict[str, torch.Tensor]:
        """The benchmark's inputs: the taxonomy and the mix's log or
        batches, on the device."""
        m = self.cfg.model
        out = generate.taxonomy(m.num_items, m.num_departments,
                                m.num_categories, self.seed, self.device)
        if "n_interactions" in self.mix:
            out.update(generate.interaction_log(
                self.mix, m.num_users, m.num_items, self.seed, self.device))
        else:
            out.update(generate.id_batches(
                self.mix, m.num_users, m.num_items, self.seed, self.device))
        return out

    def _feed(self, inp):
        """(an endless iterator of [B] batches on the device, the
        negatives' CDF, steps an epoch)."""
        from ncf_tpu_torch.data import make_sampling_cdf
        from ncf_tpu_torch.data.interactions import Interactions
        from ncf_tpu_torch.data.pipeline import DeviceEpochPipeline

        m = self.cfg.model
        if "timestamps" in inp:
            n = inp["user_ids"].numel()
            inter = Interactions(
                user_ids=inp["user_ids"].cpu().numpy(),
                item_ids=inp["item_ids"].cpu().numpy(),
                timestamps=inp["timestamps"].cpu().numpy(),
                amounts=np.ones(n, np.float32),
                num_users=m.num_users, num_items=m.num_items,
                item_dept=inp["item_dept"].cpu().numpy(),
                item_cat=inp["item_cat"].cpu().numpy(),
                num_departments=m.num_departments,
                num_categories=m.num_categories)
            pipe = DeviceEpochPipeline(inter, self.B, seed=self.pipe_seed,
                                       device=self.device)
            cdf = make_sampling_cdf(inter.inverse_popularity_weights(),
                                    device=self.device)
            feed = (b for e in itertools.count() for b in pipe.epoch(e))
            return feed, cdf, len(pipe)
        cols = ("user_ids", "item_ids", "hour", "day", "month",
                "day_of_year")
        P = inp["user_ids"].shape[0]
        feed = ({k: inp[k][i % P] for k in cols} for i in itertools.count())
        cdf = make_sampling_cdf(inp["neg_weights"], device=self.device)
        return feed, cdf, P

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from ncf_tpu_torch.models import get_model
        from ncf_tpu_torch.ops import embedding, launch_counters
        from ncf_tpu_torch.train import (init_sparse_opt_state,
                                         make_optimizer, make_schedule,
                                         make_sparse_train_step,
                                         make_train_step)
        from ncf_tpu_torch.train.trainer import _SCATTER

        cfg, m, t = self.cfg, self.cfg.model, self.cfg.train
        inp = self.inputs()
        self.feed, cdf, spe = self._feed(inp)
        dept, cat = inp["item_dept"], inp["item_cat"]
        del inp
        embedding.set_scatter_impl(*_SCATTER[t.embedding_scatter])
        model = get_model(m.name)
        self.params = weights.make_params(m, self.seed, self.device)
        if self.sparse:
            opt = make_optimizer(dataclasses.replace(
                t, gradient_clip_norm=0.0), spe)
            self.state = init_sparse_opt_state(opt, self.params)
            self.step = make_sparse_train_step(
                model, cfg, opt, make_schedule(t, spe), cdf, dept, cat,
                device=self.device)
        else:
            opt = make_optimizer(t, spe)
            self.state = opt.init(self.params)
            self.step = make_train_step(model, cfg, opt, cdf, dept, cat,
                                        device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            generate.sub_seed(self.seed, "step"))
        self._counters = launch_counters()
        S = 1 + m.negative_samples
        self.shapes = {
            "batch": self.B, "slots": S, "num_users": m.num_users,
            "num_items": m.num_items, "mf_dim": m.mf_dim,
            "mlp_dim": m.mlp_dim, "temporal_dim": m.temporal_dim,
            "hidden": list(m.mlp_hidden_dims),
            "num_departments": m.num_departments,
            "num_categories": m.num_categories, "sparse": self.sparse,
            "joint": m.candidate_mode == "joint",
            "precompute": ref_train.vocab_precompute(m, self.B * S)}
        self.checked = self._checked_steps(int(self.mix["check_steps"]))

    def _checked_steps(self, n: int) -> Dict[str, object]:
        """The first ``n`` steps of the step object the window will use:
        their losses, the first gradient each leaf gave the optimizer, and
        each leaf's change after them."""
        losses, grads = [], None
        for i in range(n):
            losses.append(float(self._one()["loss"]))
            if i == 0:
                grads = self._first_grads()
        self.sync()
        change, rows = change_norms(self.params, self.cfg.model, self.seed)
        return {"losses": losses, "grads": grads, "change": change,
                "rows": rows}

    def _first_grads(self) -> Dict[str, float]:
        """Each leaf's gradient as the optimizer got it, from its state
        after one step."""
        if self.sparse:
            mu = self.state["dense"]["dense"]["mu"]
        else:
            mu = self.state["mu"]
        out = {p: float(x.norm()) / (1.0 - B1)
               for p, x in weights.leaves(mu)}
        if self.sparse:
            for p, acc in (("user_emb", "user_acc"),
                           ("item_emb", "item_acc")):
                d = self.params[p].shape[1]
                out[p] = (d * float(self.state[acc].double().sum())) ** 0.5
        return out

    # ------------------------------------------------------------- calls

    def _one(self):
        batch = next(self.feed)
        self.params, self.state, self.gen, met = self.step(
            self.params, self.state, self.gen, batch)
        return met

    def call(self) -> int:
        self._one()
        return self.B

    def mark(self) -> None:
        """The window has closed (the checked steps ran in set-up)."""

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, int]:
        return {k: c.value for k, c in self._counters.items()}

    def release(self) -> None:
        del self.params, self.state, self.step, self.feed
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def check_batches(self, inp, n: int):
        """The first ``n`` batches the program's feed gave, worked out
        again from the inputs: for a log, the device pipeline's epochs (a
        seeded permutation an epoch, repeated to whole batches, each
        batch's rows stably sorted by user); else the pool's first
        batches."""
        cols = ("user_ids", "item_ids", "hour", "day", "month",
                "day_of_year")
        if "timestamps" not in inp:
            return [{k: inp[k][i] for k in cols} for i in range(n)]
        N = inp["user_ids"].numel()
        nb = -(-N // self.B)
        users = inp["user_ids"].to(torch.int32)
        log = dict(user_ids=users, item_ids=inp["item_ids"].to(torch.int32),
                   **generate.temporal_features(inp["timestamps"]))
        out = []
        for epoch in itertools.count():
            key = (int(self.pipe_seed) * 1_000_003 + epoch + 1) & 0x7FFFFFFF
            gen = torch.Generator(device=self.device).manual_seed(key)
            perm = torch.randperm(N, generator=gen, device=self.device)
            idx = perm.repeat(-(-nb * self.B // N))[:nb * self.B].reshape(
                nb, self.B)
            order = torch.argsort(users[idx], dim=1, stable=True)
            idx = torch.gather(idx, 1, order)
            for i in range(nb):
                if len(out) == n:
                    return out
                out.append({k: log[k][idx[i]] for k in cols})

    def reference(self, prec=ref_model.EXACT, fault=None, table_fault=None):
        """The reference's run of the checked steps: its losses, first
        gradients, changes and the tables' changes a row."""
        m, t = self.cfg.model, self.cfg.train
        inp = self.inputs()
        n = int(self.mix["check_steps"])
        batches = self.check_batches(inp, n)
        if "timestamps" in inp:
            w = generate.inverse_popularity(inp["item_ids"], m.num_items)
        else:
            w = inp["neg_weights"]
        consts = {"cdf": ref_train.sampling_cdf(w, self.device),
                  "item_dept": inp["item_dept"], "item_cat": inp["item_cat"]}
        del inp
        fused = (torch.device(self.device).type == "cuda"
                 and m.fused_tower in ("auto", "on"))
        gen = torch.Generator(device=self.device).manual_seed(
            generate.sub_seed(self.seed, "step"))
        params = weights.make_params(m, self.seed, self.device)
        run = ref_train.Reference(m, t, params, consts, gen, self.sparse,
                                  fused, prec, fault, table_fault)
        losses = [run.step(b) for b in batches]
        change, rows = change_norms(params, m, self.seed)
        out = {"losses": losses, "grads": run.first_grad, "change": change,
               "rows": rows}
        del run, params, batches, consts
        gc.collect()
        return out

    def numbers(self, got, want) -> Dict[str, float]:
        moving = ref_train.moving(want["grads"])
        first, ref_first = got["losses"][0], want["losses"][0]
        out = {"loss_gap": abs(first - ref_first) / abs(ref_first),
               "grad_gap": ref_train.worst_gap(got["grads"], want["grads"]),
               "change_gap": ref_train.median_gap(got["change"],
                                                  want["change"], moving),
               "table_gap": ref_train.table_gap(got["change"],
                                                want["change"], moving)}
        if self.sparse:
            out["stray_gap"] = ref_train.stray_gap(
                got["rows"], want["rows"], want["change"])
        return out

    def check(self, launches) -> Dict[str, float]:
        want = self.reference()
        print(f"detail losses: program {self.checked['losses']!r}, "
              f"reference {want['losses']!r}", file=sys.stderr)
        for what in ("grads", "change"):
            gaps = ref_train.leaf_gaps(self.checked[what], want[what])
            leaf = max(gaps, key=gaps.get)
            print(f"detail {what}: worst leaf {leaf} {gaps[leaf]!r} "
                  f"(program {self.checked[what][leaf]!r}, reference "
                  f"{want[what][leaf]!r})", file=sys.stderr)
        print("detail tables' change: " + ", ".join(
            f"{p} program {self.checked['change'][p]!r} reference "
            f"{want['change'][p]!r}" for p in ref_train.TABLES),
            file=sys.stderr)
        return self.numbers(self.checked, want)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control's and the faults' numbers against the reference:
        the reference one precision below the configuration's in the
        program's place; with half of each batch left out (the mean over
        the rest); with the tables' rows left unmoved while their
        optimizer state moves; and (sparse update) with each touched
        row's update written to the next row.  A state left unchanged
        reads 1 on every leaf's change by the measure, with no run."""
        want = self.reference()
        runs = {"control": self.reference(ref_model.CONTROL),
                "half_batch": self.reference(fault=_half_batch),
                "tables_frozen": self.reference(table_fault="frozen")}
        if self.sparse:
            runs["rows_shifted"] = self.reference(table_fault="shifted")
        return {k: self.numbers(v, want) for k, v in runs.items()}


def _half_batch(batch, items):
    h = items.shape[0] // 2
    return {k: v[:h] for k, v in batch.items()}, items[:h]
