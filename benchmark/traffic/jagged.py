"""Jagged purchase histories for the sequence cells (``train_hstu``).

A batch packs whole histories end to end under a budget of
``target_positions`` (a history of L items has L - 1 targets): lengths
are log-uniform integers over ``[min_len, max_len]``, drawn until the
budget is met, the last cut to fit it (it keeps 2 positions or more).
The draws are stratified: each set of ``STRATA`` consecutive draws takes
one from each sixteenth of the log range, in a random order.  Each draw
is still log-uniform, but a batch's sum of squared lengths, which the
attention's cost follows, varies far less from batch to batch and from
seed to seed than with independent draws (a pool's mean causal pairs: a
coefficient of variation over seeds of 0.34% against 1.6%).
Items follow a Zipf popularity (``item_zipf``) over a seeded order of
the catalogue, in baskets of 1 to ``basket_max`` items that share a
timestamp; the gaps between a history's baskets are log-uniform over
``[gap_min_s, gap_max_s]`` seconds.  A pool of ``pool_batches`` batches
is made at set-up, on the device, from ``--seed``: each is ``item_ids``
and ``timestamps`` int64 [T] on the device and ``offsets`` int64 [S + 1]
on the host.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch

from benchmark.traffic.generate import draw, generator, sub_seed, zipf_cdf

EPOCH_S = 1_500_000_000       # the histories start in [EPOCH_S, + 1 year)
YEAR_S = 365 * 86400
STRATA = 16


def _fractions(gen: torch.Generator) -> Iterator[float]:
    """Uniform fractions of [0, 1), in sets of ``STRATA``: one in each
    ``1 / STRATA`` of the range, in a random order."""
    while True:
        order = torch.randperm(STRATA, generator=gen).tolist()
        jitter = torch.rand(STRATA, generator=gen,
                            dtype=torch.float64).tolist()
        for k, j in zip(order, jitter):
            yield (k + j) / STRATA


def lengths(mix: Dict, gen: torch.Generator) -> np.ndarray:
    """One batch's history lengths (host int64): log-uniform integers,
    stratified, the last cut so that the targets sum to
    ``target_positions``."""
    lo, hi = int(mix["min_len"]), int(mix["max_len"])
    left = int(mix["target_positions"])
    out: List[int] = []
    fractions = _fractions(gen)
    while left > 0:
        u = next(fractions)
        L = min(int(math.exp(math.log(lo) + u * (math.log(hi + 1)
                                                  - math.log(lo)))), hi)
        L = min(L, left + 1)
        out.append(L)
        left -= L - 1
    return np.asarray(out, dtype=np.int64)


def timestamps(lens: np.ndarray, mix: Dict, gen: torch.Generator,
               device) -> torch.Tensor:
    """int64 [T] seconds: each history's start, then its baskets (1 to
    ``basket_max`` items) a log-uniform gap apart."""
    T = int(lens.sum())
    S = lens.size
    size = torch.randint(1, int(mix["basket_max"]) + 1, (T,), generator=gen,
                         device=device)
    first = torch.cumsum(size, 0) - size            # baskets' first items
    new = torch.zeros(T, dtype=torch.bool, device=device)
    new[first[first < T]] = True
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(device)
    starts = off[:-1]
    new[starts] = False                             # no gap before a start
    lg = torch.rand((T,), generator=gen, device=device, dtype=torch.float64)
    lo, hi = math.log(mix["gap_min_s"]), math.log(mix["gap_max_s"])
    gap = torch.where(new, torch.exp(lo + lg * (hi - lo)).round().long(),
                      torch.zeros((), dtype=torch.long, device=device))
    t0 = EPOCH_S + torch.randint(0, YEAR_S, (S,), generator=gen,
                                 device=device)
    seq = torch.repeat_interleave(torch.arange(S, device=device),
                                  torch.from_numpy(lens).to(device),
                                  output_size=T)
    c = torch.cumsum(gap, 0)
    return c - c[starts][seq] + t0[seq]


def hstu_batches(mix: Dict, num_items: int, seed: int,
                 device) -> List[Dict[str, object]]:
    """The pool of ``pool_batches`` jagged batches (module docstring)."""
    host = torch.Generator().manual_seed(sub_seed(seed, "hstu/lengths"))
    gen = generator(seed, "hstu", device)
    cdf = zipf_cdf(num_items, mix["item_zipf"], gen, device)
    out = []
    for _ in range(int(mix["pool_batches"])):
        lens = lengths(mix, host)
        T = int(lens.sum())
        out.append({"item_ids": draw(cdf, (T,), gen),
                    "timestamps": timestamps(lens, mix, gen, device),
                    "offsets": np.concatenate([[0], np.cumsum(lens)])})
    return out


def pairs(offsets: np.ndarray) -> int:
    """Causal pairs of real positions, sum of L (L + 1) / 2."""
    lens = np.diff(np.asarray(offsets, dtype=np.int64))
    return int((lens * (lens + 1) // 2).sum())
