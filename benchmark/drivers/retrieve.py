"""The retrieval driver: one closed-loop caller of the port's serving
path.

Set-up makes the weights and the item taxonomy from the seed, starts
``serving/server.py::ModelServer`` over them, draws the mix's pool of
calls, and makes warm-up calls until the bias under the mix's temporal
context, the prepared table and every kernel are built.  A call is one
batch of users: ``ModelServer.recommend_batch`` or, for a mix with
already-seen items, ``AdvancedNCFScorer.topk_for_users(exclude=)``.
Calls cycle through the pool; each call's answers are kept for the
check.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import spec, weights
from benchmark.reference import retrieve as ref_retrieve
from benchmark.reference.model import CONTROL, EXACT
from benchmark.traffic import generate

WARMUP_CALLS = 3
# calls a block of the answers' store: the store is a few NumPy arrays,
# not a Python object a call, so that the window's bookkeeping gives the
# garbage collector nothing to walk
STORE_BLOCK = 4096
# the route's launches of B5 a call
B5 = "topk_scores_streaming"


class Driver:
    unit_metric = "retrieve_users_per_s"
    latency_metric = "retrieve_p95_ms"

    def __init__(self, cell: spec.Cell, seed: int, device,
                 overrides: Optional[Dict] = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.mix = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
        self.cfg = spec.port_config(cell.config,
                                    {"model": (overrides or {}).get(
                                        "model", {})})
        self.k = int(self.mix["k"])
        self.temporal = dict(self.mix["temporal"])
        self.outputs = []

    # ------------------------------------------------------------ set-up

    def _inputs(self):
        m = self.cfg.model
        tax = generate.taxonomy(m.num_items, m.num_departments,
                                m.num_categories, self.seed, self.device)
        calls = generate.retrieve_calls(self.mix, m.num_users, m.num_items,
                                        self.seed, self.device)
        return tax, calls

    def _traffic(self):
        """The pool of calls on the host (the program takes NumPy ids);
        returns the taxonomy."""
        tax, calls = self._inputs()
        self.users = calls["users"].to(torch.int32).cpu().numpy()
        self.exclude = (None if calls["exclude"] is None
                        else calls["exclude"].cpu().numpy())
        return tax

    def setup(self) -> None:
        from ncf_tpu_torch.ops import launch_counters
        from ncf_tpu_torch.serving.server import ModelServer

        m = self.cfg.model
        tax = self._traffic()
        params = weights.make_params(m, self.seed, self.device)
        self.server = ModelServer(
            self.cfg, params=params, item_dept=tax["item_dept"],
            item_cat=tax["item_cat"], device=self.device)
        del params
        self._counters = launch_counters()
        fetch = self.k + (0 if self.exclude is None
                          else self.exclude.shape[2])
        self.shapes = {"users_per_call": self.users.shape[1],
                       "num_items": m.num_items, "mf_dim": m.mf_dim,
                       "k": self.k, "fetch": min(fetch, m.num_items)}
        for _ in range(WARMUP_CALLS):
            self._serve(0)
        self.sync()
        self.n_calls = 0
        self.outputs = []

    # ------------------------------------------------------------- calls

    def _serve(self, i: int):
        users = self.users[i]
        if self.exclude is None:
            scores, ids, _ = self.server.recommend_batch(
                users, k=self.k, temporal=self.temporal)
            return scores, ids
        return self.server.scorer.topk_for_users(
            users, k=self.k, temporal=self.temporal,
            exclude=self.exclude[i])

    def call(self) -> int:
        """One call (its answers are on the host when it returns)."""
        i = self.n_calls % len(self.users)
        scores, ids = self._serve(i)
        b, j = divmod(self.n_calls, STORE_BLOCK)
        if j == 0:
            self.outputs.append((np.empty((STORE_BLOCK,) + scores.shape,
                                          scores.dtype),
                                 np.empty((STORE_BLOCK,) + ids.shape,
                                          ids.dtype)))
        self.outputs[b][0][j] = scores
        self.outputs[b][1][j] = ids
        self.n_calls += 1
        return self.users.shape[1]

    def answer(self, n: int):
        """(pool index, scores, ids) of the window's call ``n``."""
        b, j = divmod(n, STORE_BLOCK)
        return (n % len(self.users), self.outputs[b][0][j],
                self.outputs[b][1][j])

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def mark(self) -> None:
        """The window has closed: later calls (the traced slice) are not
        judged."""
        self.window_calls = self.n_calls

    def counters(self) -> Dict[str, int]:
        """Every kernel wrapper's launches so far."""
        return {k: c.value for k, c in self._counters.items()}

    def release(self) -> None:
        self.server.close()
        del self.server
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _reference(self, prec):
        m = self.cfg.model
        tax, _ = self._inputs()
        params = weights.make_params(m, self.seed, self.device)
        return ref_retrieve.Reference(params, m, self.temporal,
                                      tax["item_dept"], tax["item_cat"],
                                      prec)

    def sample(self, n_done: int):
        """Indices of the window's calls to judge, drawn from the seed."""
        rng = np.random.default_rng(generate.sub_seed(self.seed, "check"))
        n = min(int(self.mix["check_calls"]), n_done)
        return sorted(rng.choice(n_done, size=n, replace=False).tolist())

    def numbers(self, answers, reference=None) -> Dict[str, float]:
        """The compared numbers of ``answers`` (pool index, scores, ids)."""
        reference = reference or self._reference(EXACT)
        rows = []
        for i, scores, ids in answers:
            ex = None if self.exclude is None else self.exclude[i]
            truth = reference.logits(self.users[i])
            rows.append(ref_retrieve.judge(truth, scores, ids, ex))
        return ref_retrieve.worst(rows)

    def check(self, launches: Dict[str, float]) -> Dict[str, float]:
        """The numbers of a sample of the window's answers, and the
        route's B5 launches a call in the window (``launches``) against
        the mix's."""
        picked = [self.answer(n) for n in self.sample(self.window_calls)]
        self.outputs = []
        out = self.numbers(picked)
        out["route_mismatch"] = abs(launches[B5]
                                    - float(self.mix["b5_launches_per_call"]))
        return out

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control's numbers: the reference one precision below the
        configuration's answers as many calls of the pool as a run
        judges, in the program's place, judged as the program's answers
        are."""
        n_calls = int(self.mix["check_calls"])
        self._traffic()
        low = self._reference(CONTROL)
        answers = []
        for i in range(n_calls):
            ex = None if self.exclude is None else self.exclude[i]
            scores, ids = low.answer(self.users[i], self.k, ex)
            answers.append((i, scores, ids))
        del low
        return {"control": self.numbers(answers)}
