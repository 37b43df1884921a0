"""Dispatch-granularity autotuning: choose steps_per_dispatch from the
measured per-dispatch overhead.

Port of ``ncf_tpu/train/autotune.py``.  ``cfg.train.steps_per_dispatch =
0`` asks the ``Trainer`` to measure, at start-up, how much a dispatch
costs beside one optimizer step and to pick the smallest K (1, 8, 16, 32)
that keeps the amortized dispatch overhead under 5 % of the step.  Each
timed region ends in ``torch.cuda.synchronize()`` (on the CPU the loss is
read), and per-step costs come from the DIFFERENCE of a short and a long
chained run, which cancels the fixed cost of the synchronisation.

The port's steps update the params and the Adam moments in place and
advance their generator, so every probe runs on deep copies of the
params and optimizer state and on a clone of the generator: the probe
leaves the training state and its random stream as they were.  The
port's multi-step is a Python loop over K single steps, so it saves no
dispatch and the answer is usually K=1.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict

import torch

from ncf_tpu_torch.convert import tree_map

log = logging.getLogger(__name__)

PROBE_K = 8                 # the multi-step probe's length
CANDIDATE_KS = (8, 16, 32)  # Ks we are willing to dispatch
TARGET_FRAC = 0.05          # dispatch overhead budget as fraction of step


def _copy_state(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _sync(metrics) -> None:
    loss = metrics["loss"]
    if loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)
    else:
        float(loss)


def _chained(step_fn, state, batches, m: int) -> float:
    """Time m chained dispatches ending in a synchronisation."""
    params, opt_state, gen = state
    t0 = time.perf_counter()
    metrics = None
    for i in range(m):
        params, opt_state, gen, metrics = step_fn(
            params, opt_state, gen, batches[i % len(batches)])
    _sync(metrics)
    dt = time.perf_counter() - t0
    state[:] = [params, opt_state, gen]
    return dt


def choose_steps_per_dispatch(
    make_single,                 # () -> train_step(params, opt, gen, batch)
    make_multi,                  # () -> multi_step(params, opt, gen, [K,B] batches)
    params,
    opt_state,
    rng: torch.Generator,
    probe_batch: Dict[str, torch.Tensor],
    stack_batch,                 # (batch, K) -> stacked device batch [K, B]
) -> int:
    """Measure single-dispatch vs multi-step per-step cost and pick K."""
    single = make_single()
    state = [_copy_state(params), _copy_state(opt_state),
             _clone_generator(rng)]
    _chained(single, state, [probe_batch], 2)            # warm-up
    t_short = _chained(single, state, [probe_batch], 4)
    t_long = _chained(single, state, [probe_batch], 16)
    per_single = max(1e-9, (t_long - t_short) / 12)

    multi = make_multi()
    stacked = stack_batch(probe_batch, PROBE_K)
    state = [_copy_state(params), _copy_state(opt_state),
             _clone_generator(rng)]
    _chained(multi, state, [stacked], 1)                 # warm-up
    t_short = _chained(multi, state, [stacked], 1)
    t_long = _chained(multi, state, [stacked], 3)
    per_scan = max(1e-9, (t_long - t_short) / (2 * PROBE_K))

    overhead = per_single - per_scan
    if overhead <= TARGET_FRAC * per_scan:
        k = 1
    else:
        want = math.ceil(overhead / (TARGET_FRAC * per_scan))
        k = next((c for c in CANDIDATE_KS if c >= want), CANDIDATE_KS[-1])
    log.info(
        "autotune steps_per_dispatch: single=%.3f ms/step scan=%.3f ms/step "
        "dispatch_overhead=%.3f ms -> K=%d",
        per_single * 1e3, per_scan * 1e3, overhead * 1e3, k)
    return k
