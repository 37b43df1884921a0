"""Interaction log container: id mapping, splits, popularity statistics.

The port's copy of ``ncf_tpu/data/interactions.py`` (NumPy only; the port imports nothing
of the JAX package), so both packages build identical arrays from one
seed.

TPU-native re-design of the reference `SheetzDataset` preprocessing
(reference: src/model/data_prep.py:13-176).  The reference builds Python
dict id-maps, per-row Python loops and per-user positive sets in pandas
chunks; here everything is vectorized NumPy on host, producing dense,
static-shape arrays that feed straight into device batches.

Key reproduced semantics:
- id mapping from raw user/item keys to contiguous indices
  (data_prep.py:65-71);
- time-based train/validation split at ``max(ts) - validation_days``
  (data_prep.py:77-88);
- inverse-popularity negative-sampling weights ``w ~ 1/count`` normalized
  (data_prep.py:94-102);
- per-user positive-set history (data_prep.py:163-176) — here as a CSR-style
  (offsets, values) pair usable from both host and device code.

Additionally provides the *correct* leave-one-out eval split (1 held-out
positive per user, ranked against sampled negatives) which the reference
intended but got wrong (SURVEY.md §2.9.9).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

SECONDS_PER_DAY = 86400


@dataclass
class Interactions:
    """A dense interaction log with contiguous ids, sorted by timestamp.

    Attributes
    ----------
    user_ids, item_ids : int32 [N] contiguous indices
    timestamps : int64 [N] unix seconds
    amounts : float32 [N] transaction amount / rating (1.0 if absent)
    num_users, num_items : table sizes
    user_map / item_map : raw key -> contiguous index
    item_dept, item_cat : optional int32 [num_items] category metadata
    """

    user_ids: np.ndarray
    item_ids: np.ndarray
    timestamps: np.ndarray
    amounts: np.ndarray
    num_users: int
    num_items: int
    user_map: Dict = field(default_factory=dict)
    item_map: Dict = field(default_factory=dict)
    item_dept: Optional[np.ndarray] = None
    item_cat: Optional[np.ndarray] = None
    num_departments: int = 1
    num_categories: int = 1

    def __post_init__(self):
        self.user_ids = np.asarray(self.user_ids, dtype=np.int32)
        self.item_ids = np.asarray(self.item_ids, dtype=np.int32)
        self.timestamps = np.asarray(self.timestamps, dtype=np.int64)
        self.amounts = np.asarray(self.amounts, dtype=np.float32)

    def __len__(self) -> int:
        return int(self.user_ids.shape[0])

    # ------------------------------------------------------------- factory

    @classmethod
    def from_raw(
        cls,
        raw_users: np.ndarray,
        raw_items: np.ndarray,
        timestamps: np.ndarray,
        amounts: Optional[np.ndarray] = None,
        item_dept: Optional[Dict] = None,
        item_cat: Optional[Dict] = None,
    ) -> "Interactions":
        """Build contiguous id maps from raw keys (data_prep.py:65-71) and
        sort chronologically."""
        u_keys, u_idx = np.unique(raw_users, return_inverse=True)
        i_keys, i_idx = np.unique(raw_items, return_inverse=True)
        order = np.argsort(timestamps, kind="stable")
        amounts = np.ones(len(u_idx), np.float32) if amounts is None else amounts

        user_map = {k: j for j, k in enumerate(u_keys.tolist())}
        item_map = {k: j for j, k in enumerate(i_keys.tolist())}

        dept_arr = cat_arr = None
        n_dept = n_cat = 1
        if item_dept is not None:
            dept_vals = sorted({v for v in item_dept.values()})
            dmap = {v: j for j, v in enumerate(dept_vals)}
            dept_arr = np.zeros(len(i_keys), np.int32)
            for k, j in item_map.items():
                dept_arr[j] = dmap.get(item_dept.get(k, dept_vals[0]), 0)
            n_dept = len(dept_vals)
        if item_cat is not None:
            cat_vals = sorted({v for v in item_cat.values()})
            cmap = {v: j for j, v in enumerate(cat_vals)}
            cat_arr = np.zeros(len(i_keys), np.int32)
            for k, j in item_map.items():
                cat_arr[j] = cmap.get(item_cat.get(k, cat_vals[0]), 0)
            n_cat = len(cat_vals)

        return cls(
            user_ids=u_idx[order],
            item_ids=i_idx[order],
            timestamps=np.asarray(timestamps)[order],
            amounts=np.asarray(amounts, np.float32)[order],
            num_users=len(u_keys),
            num_items=len(i_keys),
            user_map=user_map,
            item_map=item_map,
            item_dept=dept_arr,
            item_cat=cat_arr,
            num_departments=n_dept,
            num_categories=n_cat,
        )

    # ------------------------------------------------------------- slicing

    def select(self, mask: np.ndarray) -> "Interactions":
        return Interactions(
            user_ids=self.user_ids[mask],
            item_ids=self.item_ids[mask],
            timestamps=self.timestamps[mask],
            amounts=self.amounts[mask],
            num_users=self.num_users,
            num_items=self.num_items,
            user_map=self.user_map,
            item_map=self.item_map,
            item_dept=self.item_dept,
            item_cat=self.item_cat,
            num_departments=self.num_departments,
            num_categories=self.num_categories,
        )

    # --------------------------------------------------------------- stats

    def item_popularity(self) -> np.ndarray:
        """Interaction count per item, int64 [num_items]."""
        return np.bincount(self.item_ids, minlength=self.num_items).astype(np.int64)

    def inverse_popularity_weights(self, smoothing: float = 1.0) -> np.ndarray:
        """Normalized sampling weights ``w ~ 1/(count + smoothing)``
        (reference semantics, data_prep.py:94-102; smoothing keeps
        never-seen items sampleable)."""
        counts = self.item_popularity().astype(np.float64)
        w = 1.0 / np.maximum(counts + smoothing, 1e-12)
        return (w / w.sum()).astype(np.float32)

    def user_histories(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-user positive sets as CSR (offsets[int64, U+1], items[int32, N]),
        items sorted within each user for binary-search membership tests.
        Replaces the chunked Python set-building at data_prep.py:163-176."""
        order = np.lexsort((self.item_ids, self.user_ids))
        u = self.user_ids[order]
        items = self.item_ids[order]
        counts = np.bincount(u, minlength=self.num_users)
        offsets = np.zeros(self.num_users + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return offsets, items.astype(np.int32)

    def recent_history(self, max_len: int = 50) -> np.ndarray:
        """Per-user most-recent item ids, int32 [num_users, max_len]
        padded with -1, newest first — the last-50 sequence features of
        the reference (training_data.py:72-81, features.py:74 LIMIT 50),
        vectorized."""
        # order rows newest-first within each user
        order = np.lexsort((-self.timestamps, self.user_ids))
        u = self.user_ids[order]
        items = self.item_ids[order]
        counts = np.bincount(u, minlength=self.num_users)
        starts = np.zeros(self.num_users, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(len(u)) - starts[u]
        keep = rank < max_len
        out = np.full((self.num_users, max_len), -1, np.int32)
        out[u[keep], rank[keep]] = items[keep]
        return out

    def causal_history(self, max_len: int = 50) -> np.ndarray:
        """Strictly-causal per-EXAMPLE contexts: int32 [N, max_len], row j
        holding the ``max_len`` items this row's user interacted with
        strictly BEFORE row j (newest first, padded -1).

        ``recent_history`` is a per-USER table where items purchased
        after an example's timestamp stay visible during training — the
        same approximation the reference's last-50 feature pipeline
        makes (features.py:74).  This variant removes it (roadmap #5) at
        the cost of an [N, max_len] host table."""
        n = len(self)
        # stable chronological order within each user (ties by log order)
        order = np.lexsort((np.arange(n), self.timestamps, self.user_ids))
        u = self.user_ids[order]
        items_ordered = self.item_ids[order]
        counts = np.bincount(u, minlength=self.num_users)
        starts = np.zeros(self.num_users, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(n) - starts[u]                      # within-user k
        # history column c of ordered row j = items_ordered[j - 1 - c]
        cols = np.arange(max_len)[None, :]
        src = np.arange(n)[:, None] - 1 - cols               # [N, H] global
        valid = (rank[:, None] - 1 - cols) >= 0              # stays in-user
        hist_ordered = np.where(
            valid, items_ordered[np.clip(src, 0, n - 1)], -1).astype(np.int32)
        out = np.empty((n, max_len), np.int32)
        out[order] = hist_ordered
        return out

    # --------------------------------------------------------------- splits

    def time_split(self, validation_days: int) -> Tuple["Interactions", "Interactions"]:
        """Train/val split at ``max(ts) - validation_days`` (data_prep.py:77-88)."""
        cutoff = int(self.timestamps.max()) - validation_days * SECONDS_PER_DAY
        train_mask = self.timestamps <= cutoff
        log.info(
            "time_split: cutoff=%d train=%d val=%d",
            cutoff, int(train_mask.sum()), int((~train_mask).sum()),
        )
        return self.select(train_mask), self.select(~train_mask)

    def leave_one_out(self) -> Tuple["Interactions", np.ndarray, np.ndarray]:
        """Leave-one-out split: hold out each user's LAST interaction.

        Returns (train_interactions, eval_users[int32, U'], eval_items[int32, U'])
        where U' = users with >= 2 interactions.  This is the standard NCF
        eval protocol the reference intended (SURVEY.md §2.9.9 / BASELINE.md).
        """
        # interactions are time-sorted; the last occurrence per user is the
        # held-out positive.
        last_idx = np.full(self.num_users, -1, np.int64)
        last_idx[self.user_ids] = np.arange(len(self))  # last write wins (sorted)
        counts = np.bincount(self.user_ids, minlength=self.num_users)
        eligible = counts >= 2
        holdout = last_idx[eligible]
        mask = np.ones(len(self), bool)
        mask[holdout] = False
        eval_users = np.nonzero(eligible)[0].astype(np.int32)
        eval_items = self.item_ids[holdout].astype(np.int32)
        return self.select(mask), eval_users, eval_items
