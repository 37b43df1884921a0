"""The sequence-training driver: HSTU's training step, one step a call.

Set-up makes the weights (``hstu_weights.py``) and a pool of jagged
batches (``traffic/jagged.py``) from the seed, builds the step as
``train/trainer.py`` does for the configuration
(``train/step.py::make_sparse_train_step``: the item table's touched
rows by rowwise Adagrad, the rest by Adam), then drives that same step
object through the mix's checked steps, which build every kernel, and
hands it to the window, which cycles the pool.  After the first checked
step it reads the gradient each leaf gave the optimizer from the
optimizer's state, and after the last the norm of each leaf's change
from the seeded weights (the table remade block by block).  From
``mark()`` on it records the batches the traced slice runs and keeps
their mean causal pairs, positions and sequences a step in ``shapes``,
so the rooflines count the work of what ran.

The check follows the checked steps with ``reference/hstu.py`` and
compares, as the other training cells do: ``loss_gap`` (step 1's loss),
``grad_gap`` (the worst leaf's first gradient, w_pos, w_ts and the
table's touched rows included), ``change_gap`` (the median moving
leaf's change) and ``table_gap`` (the item table's change); and
``bias_gap``, the worst relative bias table's first gradient compared
entry by entry (the norm of the difference over the reference's norm):
a norm is blind to where a gradient lands, and a causal mask one
position off moves the gradient onto w_pos's entries past the diagonal
and changes no norm by more than the rounding does.  ``stray_gap`` (the program's change of
the rows the reference left unmoved, over the reference's change of the
table) is printed and not compared: the cell's checked steps draw 128
uniform negatives at each of 262,144 positions three times, about 25
occurrences a row of the 4M, so no row stays unmoved and it reads 0
whatever the program writes.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import hstu_weights, spec, weights
from benchmark.reference import hstu as ref_hstu
from benchmark.reference import model as ref_model
from benchmark.reference.train import B1, leaf_gaps, median_gap, moving
from benchmark.traffic import generate, jagged

TABLE = ref_hstu.TABLE


def change_norms(params, m, seed: int):
    """Each leaf's norm of its change from the seeded weights, and the
    table's squared change a row (f32, on the host)."""
    dev = params[TABLE].device
    start = dict(weights.leaves(hstu_weights.layout(m)))
    make = hstu_weights.leaf_maker(seed, dev)
    out, rows = {}, None
    for path, cur in weights.leaves(params):
        spec_ = start[path]
        if spec_[0] == "table":
            parts = []
            for b in range(weights.table_blocks(spec_[1])):
                lo = b * weights.TABLE_BLOCK
                init = hstu_weights.table_block(seed, path, spec_, b, dev)
                parts.append((cur[lo:lo + init.shape[0]].float() - init)
                             .square().sum(1).cpu())
                del init
            rows = torch.cat(parts)
            out[path] = float(rows.double().sum()) ** 0.5
        else:
            out[path] = float((cur.float() - make(path, spec_)).norm())
    return out, rows


def table_gap(prog, want, only) -> float:
    return leaf_gaps(prog, want, only)[TABLE]


def bias_gap(prog, want) -> float:
    return max(float((prog[p] - w).norm() / w.norm().clamp(min=1e-30))
               for p, w in want.items())


def stray_gap(prog_rows, want_rows, want) -> float:
    return float(prog_rows[want_rows == 0].double().sum()) ** 0.5 / max(
        want[TABLE], 1e-30)


class Driver:
    unit_metric = "train_examples_per_s"
    latency_metric = None

    def __init__(self, cell: spec.Cell, seed: int, device,
                 overrides: Optional[Dict] = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        ov = overrides or {}
        self.mix = dict(cell.traffic, **ov.get("traffic", {}))
        self.B = int(self.mix["target_positions"])
        self.cfg = spec.port_config(cell.config, {
            "model": ov.get("model", {}), "train": {"batch_size": self.B}})
        if self.cfg.model.name != "hstu":
            raise ValueError("the train_hstu driver runs the hstu model")

    def inputs(self):
        return jagged.hstu_batches(self.mix, self.cfg.model.num_items,
                                   self.seed, self.device)

    def setup(self) -> None:
        from ncf_tpu_torch.models import get_model
        from ncf_tpu_torch.ops import embedding, launch_counters
        from ncf_tpu_torch.train import (init_sparse_opt_state,
                                         make_optimizer, make_schedule,
                                         make_sparse_train_step)
        from ncf_tpu_torch.train.step import sparse_mode_available
        from ncf_tpu_torch.train.trainer import _SCATTER

        cfg, m, t = self.cfg, self.cfg.model, self.cfg.train
        if not sparse_mode_available(cfg):
            raise ValueError("the cell's configuration takes no sparse "
                             "table update")
        self.pool = self.inputs()
        P = len(self.pool)
        embedding.set_scatter_impl(*_SCATTER[t.embedding_scatter])
        model = get_model(m.name)
        self.params = hstu_weights.make_params(m, self.seed, self.device)
        opt = make_optimizer(dataclasses.replace(t, gradient_clip_norm=0.0),
                             P)
        self.state = init_sparse_opt_state(opt, self.params)
        self.step = make_sparse_train_step(model, cfg, opt,
                                           make_schedule(t, P),
                                           device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            generate.sub_seed(self.seed, "step"))
        self._counters = launch_counters()
        self.i = 0
        self.traced = None
        self.shapes = {
            "targets": self.B, "item_dim": m.item_embedding_dim,
            "blocks": m.num_blocks, "heads": m.num_heads,
            "attention_dim": m.attention_dim, "linear_dim": m.linear_dim,
            "max_len": m.max_sequence_length,
            "negatives": m.negative_samples}
        self.checked = self._checked_steps(int(self.mix["check_steps"]))

    def _checked_steps(self, n: int):
        losses, grads, bias = [], None, None
        for i in range(n):
            losses.append(float(self._one()["loss"]))
            if i == 0:
                grads, bias = self._first_grads()
        self.sync()
        change, rows = change_norms(self.params, self.cfg.model, self.seed)
        return {"losses": losses, "grads": grads, "change": change,
                "rows": rows, "bias": bias}

    def _first_grads(self):
        """Each leaf's first gradient's norm, and the bias tables' whole
        (host f32)."""
        mu = self.state["dense"]["dense"]["mu"]
        out = {p: float(x.norm()) / (1.0 - B1)
               for p, x in weights.leaves(mu)}
        d = self.params[TABLE].shape[1]
        out[TABLE] = (d * float(self.state["item_acc"].double().sum())) ** 0.5
        bias = {p: (x / (1.0 - B1)).float().cpu()
                for p, x in weights.leaves(mu) if p.endswith(ref_hstu.BIAS)}
        return out, bias

    def _one(self):
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        if self.traced is not None:
            self._record(batch["offsets"])
        self.params, self.state, self.gen, met = self.step(
            self.params, self.state, self.gen, batch)
        return met

    def _record(self, offsets) -> None:
        self.traced.append((jagged.pairs(offsets), int(offsets[-1]),
                            offsets.size - 1))
        pairs, pos, seqs = np.mean(np.asarray(self.traced, np.float64), 0)
        self.shapes.update(pairs=float(pairs), positions=float(pos),
                           sequences=float(seqs))

    def call(self) -> int:
        self._one()
        return self.B

    def mark(self) -> None:
        """The window has closed: from here the driver records the
        batches it runs and keeps their mean sizes in ``shapes``."""
        self.traced = []

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def counters(self) -> Dict[str, int]:
        return {k: c.value for k, c in self._counters.items()}

    def release(self) -> None:
        del self.params, self.state, self.step, self.pool
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def reference(self, prec=ref_model.EXACT, fault=None, table_fault=None):
        m, t = self.cfg.model, self.cfg.train
        pool = self.inputs()
        n = int(self.mix["check_steps"])
        gen = torch.Generator(device=self.device).manual_seed(
            generate.sub_seed(self.seed, "step"))
        params = hstu_weights.make_params(m, self.seed, self.device)
        run = ref_hstu.Reference(m, t, params, gen, prec, fault, table_fault)
        losses = [run.step(pool[i % len(pool)]) for i in range(n)]
        change, rows = change_norms(params, m, self.seed)
        out = {"losses": losses, "grads": run.first_grad, "change": change,
               "rows": rows, "bias": run.first_bias}
        del run, params, pool
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, got, want) -> Dict[str, float]:
        mv = moving(want["grads"])
        first, ref_first = got["losses"][0], want["losses"][0]
        return {"loss_gap": abs(first - ref_first) / abs(ref_first),
                "grad_gap": max(leaf_gaps(got["grads"],
                                          want["grads"]).values()),
                "change_gap": median_gap(got["change"], want["change"], mv),
                "table_gap": table_gap(got["change"], want["change"], mv),
                "stray_gap": stray_gap(got["rows"], want["rows"],
                                       want["change"]),
                "bias_gap": bias_gap(got["bias"], want["bias"])}

    def check(self, launches) -> Dict[str, float]:
        want = self.reference()
        print(f"detail losses: program {self.checked['losses']!r}, "
              f"reference {want['losses']!r}", file=sys.stderr)
        for what in ("grads", "change"):
            gaps = leaf_gaps(self.checked[what], want[what])
            leaf = max(gaps, key=gaps.get)
            print(f"detail {what}: worst leaf {leaf} {gaps[leaf]!r} "
                  f"(program {self.checked[what][leaf]!r}, reference "
                  f"{want[what][leaf]!r})", file=sys.stderr)
        print(f"detail table's change: program "
              f"{self.checked['change'][TABLE]!r} reference "
              f"{want['change'][TABLE]!r}", file=sys.stderr)
        return self.numbers(self.checked, want)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control's and the faults' numbers against the reference:
        the reference one precision below the configuration's in the
        program's place; a block's bias left out; a softmax in SiLU/N's
        place; the causal mask one position off; half the batch; the
        table frozen while its accumulator moves; each touched row's
        update written to the next row."""
        want = self.reference()
        runs = {"control": self.reference(ref_model.CONTROL)}
        for fault in ref_hstu.FAULTS[1:]:
            runs[fault] = self.reference(fault=fault)
        runs["tables_frozen"] = self.reference(table_fault="frozen")
        runs["rows_shifted"] = self.reference(table_fault="shifted")
        return {k: self.numbers(v, want) for k, v in runs.items()}
