"""Jagged histories for sequence models (HSTU, ``models/hstu.py``).

A user's interactions in time order form one sequence; a history longer
than ``max_len`` is cut into consecutive windows of at most ``max_len``
positions.  An epoch shuffles the sequences (a generator seeded per
(seed, epoch)) and packs them end to end into batches of a fixed budget
of target positions (a sequence of L positions has L - 1 targets): a
sequence that does not fit the rest of the budget is cut to it and its
remainder left out of the epoch, so every batch but an epoch's last
trains exactly ``target_positions``.  Sequences of one position have no
target and are left out.  A batch is ``item_ids`` and ``timestamps``
int64 [T] and ``offsets`` int64 [S + 1], on the host.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ncf_tpu_torch.data.interactions import Interactions


def user_histories(inter: Interactions, max_len: int):
    """(offsets int64 [S + 1], item_ids int64 [T], timestamps int64 [T]):
    every user's interactions in time order, in windows of at most
    ``max_len``, users in id order."""
    order = np.lexsort((inter.timestamps, inter.user_ids))
    users = inter.user_ids[order]
    starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]])
    ends = np.r_[starts[1:], users.size]
    bounds = [np.arange(s, e, max_len) for s, e in zip(starts, ends)]
    cuts = np.concatenate(bounds + [np.array([users.size])]) if bounds \
        else np.zeros(1, np.int64)
    return (cuts.astype(np.int64), inter.item_ids[order].astype(np.int64),
            inter.timestamps[order].astype(np.int64))


class JaggedBatches:
    """The epochs of packed histories of ``inter`` (module docstring)."""

    def __init__(self, inter: Interactions, target_positions: int,
                 max_len: int, seed: int = 0):
        if target_positions < 1 or max_len < 2:
            raise ValueError("target_positions must be positive and "
                             "max_len at least 2")
        off, self.items, self.times = user_histories(inter, max_len)
        lens = np.diff(off)
        keep = lens >= 2
        self.starts, self.lens = off[:-1][keep], lens[keep]
        self.budget = int(target_positions)
        self.seed = int(seed)

    def __len__(self) -> int:
        return max(1, -(-int((self.lens - 1).sum()) // self.budget))

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng([self.seed, int(epoch)])
        order = rng.permutation(self.lens.size)
        pieces, left = [], self.budget
        for s in order:
            L = int(min(self.lens[s], left + 1))
            pieces.append((int(self.starts[s]), L))
            left -= L - 1
            if left == 0:
                yield self._batch(pieces)
                pieces, left = [], self.budget
        if pieces:
            yield self._batch(pieces)

    def _batch(self, pieces) -> Dict[str, np.ndarray]:
        idx = np.concatenate([np.arange(s, s + L) for s, L in pieces])
        lens = np.array([L for _, L in pieces], dtype=np.int64)
        return {"item_ids": self.items[idx], "timestamps": self.times[idx],
                "offsets": np.concatenate([[0], np.cumsum(lens)])}
