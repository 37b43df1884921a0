"""Feature store and per-request feature processing.

Port of ``ncf_tpu/serving/features.py`` (host NumPy only, as there):

1. ``FeatureStore``: the enriched user and product features (last-50
   interactions, top-5 category preferences, hourly and daily visit
   patterns, account age and interaction frequency; unique customers,
   purchase and revenue statistics, co-purchases, hourly and daily sales,
   loyalty), aggregated over the interaction log.
2. ``FeatureProcessor``: per-customer feature assembly, product
   enrichment with popularity and an explanation string, metric
   normalization and model-input packing.

The counts are ``bincount``s and the last-N histories one stable sort
where the reference adds with ``np.add.at`` and walks the log row by row;
the results are equal (counts are integers below 2^24, exact in float32).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ncf_tpu_torch.data.interactions import SECONDS_PER_DAY, Interactions
from ncf_tpu_torch.data.synthetic import TAXONOMY, temporal_features

DEPT_NAMES = list(TAXONOMY.keys())
CAT_NAMES = [c for cats in TAXONOMY.values() for (c, _) in cats]


def _counts(rows: np.ndarray, cols: np.ndarray, shape) -> np.ndarray:
    """float32 ``[R, C]`` counts of the (row, col) pairs."""
    flat = rows.astype(np.int64) * shape[1] + cols
    return np.bincount(flat, minlength=shape[0] * shape[1]).reshape(
        shape).astype(np.float32)


class FeatureStore:
    """Precomputed enriched user/product features (the 'feature views')."""

    def __init__(self, interactions: Interactions, history_len: int = 50):
        self.inter = interactions
        self.history_len = history_len
        self._build()

    def _build(self) -> None:
        inter = self.inter
        U, I = inter.num_users, inter.num_items
        hour, day, _, _ = temporal_features(inter.timestamps)

        # ------------------------------------------------ user aggregates
        self.user_count = np.bincount(inter.user_ids, minlength=U)
        self.user_spend = np.bincount(
            inter.user_ids, weights=inter.amounts, minlength=U)
        first_ts = np.full(U, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first_ts, inter.user_ids, inter.timestamps)
        last_ts = np.zeros(U, np.int64)
        np.maximum.at(last_ts, inter.user_ids, inter.timestamps)
        self.user_first_ts = np.where(self.user_count > 0, first_ts, 0)
        self.user_last_ts = last_ts
        now = int(inter.timestamps.max()) if len(inter) else 0
        self.user_account_age_days = np.maximum(
            (now - self.user_first_ts) // SECONDS_PER_DAY, 0)
        self.user_interaction_frequency = self.user_count / np.maximum(
            self.user_account_age_days, 1)

        # hourly / daily visit patterns [U, 24] / [U, 7]
        self.user_hourly = _counts(inter.user_ids, hour, (U, 24))
        self.user_daily = _counts(inter.user_ids, day, (U, 7))

        # per-user category counts -> top-5 preferences
        if inter.item_cat is not None:
            self.user_cat_counts = _counts(
                inter.user_ids, inter.item_cat[inter.item_ids],
                (U, inter.num_categories))
        else:
            self.user_cat_counts = None
        self._hist = self._histories()

        # ---------------------------------------------- product aggregates
        self.item_purchases = np.bincount(inter.item_ids, minlength=I)
        self.item_revenue = np.bincount(
            inter.item_ids, weights=inter.amounts, minlength=I)
        pairs = np.unique(
            inter.user_ids.astype(np.int64) * I + inter.item_ids)
        self.item_unique_customers = np.bincount(
            (pairs % I).astype(np.int64), minlength=I)
        self.item_avg_price = self.item_revenue / np.maximum(
            self.item_purchases, 1)
        self.item_hourly = _counts(inter.item_ids, hour, (I, 24))
        self.item_daily = _counts(inter.item_ids, day, (I, 7))
        # popularity score normalized to [0, 1]
        maxp = max(1, self.item_purchases.max())
        self.item_popularity = self.item_purchases / maxp
        # loyalty: repeat-purchase ratio (purchase_loyalty_score analogue)
        self.item_loyalty = 1.0 - self.item_unique_customers / np.maximum(
            self.item_purchases, 1)

    def _histories(self) -> List[List[tuple]]:
        """Each user's last ``history_len`` (item, timestamp, amount),
        newest first: the reference's walk over the log in reverse
        stable timestamp order, as one stable sort by user."""
        inter = self.inter
        newest = np.argsort(inter.timestamps, kind="stable")[::-1]
        users = inter.user_ids[newest]
        by_user = np.argsort(users, kind="stable")
        rows, users = newest[by_user], users[by_user]
        first = np.searchsorted(users, users, side="left")
        keep = np.arange(len(rows)) - first < self.history_len
        rows, users = rows[keep], users[keep]
        ends = np.cumsum(np.bincount(users, minlength=inter.num_users))
        recs = list(zip(inter.item_ids[rows].tolist(),
                        inter.timestamps[rows].tolist(),
                        inter.amounts[rows].tolist()))
        return [recs[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]

    # ---------------------------------------------------------- accessors

    def user_history(self, user_id: int) -> List[Dict]:
        return [{"item_id": i, "timestamp": ts, "amount": a}
                for (i, ts, a) in self._hist[user_id]]

    def top_categories(self, user_id: int, k: int = 5) -> List[Dict]:
        """Top-k category preferences (feature view's top-5)."""
        if self.user_cat_counts is None:
            return []
        counts = self.user_cat_counts[user_id]
        top = np.argsort(-counts)[:k]
        total = max(1.0, counts.sum())
        return [{"category": CAT_NAMES[c] if c < len(CAT_NAMES) else str(c),
                 "count": int(counts[c]),
                 "share": float(counts[c] / total)}
                for c in top if counts[c] > 0]

    def co_purchases(self, item_id: int, k: int = 10) -> List[Dict]:
        """Top co-purchased items, computed lazily per item."""
        inter = self.inter
        rows = np.nonzero(inter.item_ids == item_id)[0]
        users = np.unique(inter.user_ids[rows])
        if len(users) == 0:
            return []
        mask = np.isin(inter.user_ids, users)
        other = inter.item_ids[mask]
        counts = np.bincount(other, minlength=inter.num_items)
        counts[item_id] = 0
        top = np.argsort(-counts)[:k]
        base = max(1, len(rows))
        return [{"item_id": int(i), "count": int(counts[i]),
                 "pair_ratio": float(counts[i] / base)}
                for i in top if counts[i] > 0]


class FeatureProcessor:
    """Per-request feature assembly and enrichment."""

    def __init__(self, store: FeatureStore,
                 item_names: Optional[List[str]] = None):
        self.store = store
        inter = store.inter
        self.item_names = item_names or [
            f"item_{i}" for i in range(inter.num_items)]

    def get_features(self, user_id: int) -> Dict:
        """Basic, temporal and sequence features for one user."""
        s = self.store
        uid = int(user_id)
        hourly = s.user_hourly[uid]
        daily = s.user_daily[uid]
        return {
            "user_id": uid,
            "basic": {
                "total_interactions": int(s.user_count[uid]),
                "total_spend": float(s.user_spend[uid]),
                "account_age_days": int(s.user_account_age_days[uid]),
                "interaction_frequency": float(
                    s.user_interaction_frequency[uid]),
            },
            "temporal": {
                "hourly_pattern": (hourly / max(1.0, hourly.sum())).tolist(),
                "daily_pattern": (daily / max(1.0, daily.sum())).tolist(),
                "peak_hour": int(np.argmax(hourly)),
                "peak_day": int(np.argmax(daily)),
            },
            "sequence": s.user_history(uid),
            "category_preferences": s.top_categories(uid),
        }

    def enrich_products(self, item_ids, scores=None) -> List[Dict]:
        """Product metadata, popularity and explanation strings."""
        s = self.store
        inter = s.inter
        out = []
        for rank, item in enumerate(np.atleast_1d(item_ids)):
            item = int(item)
            dept = (DEPT_NAMES[inter.item_dept[item]]
                    if inter.item_dept is not None
                    and inter.item_dept[item] < len(DEPT_NAMES) else None)
            cat = (CAT_NAMES[inter.item_cat[item]]
                   if inter.item_cat is not None
                   and inter.item_cat[item] < len(CAT_NAMES) else None)
            pop = float(s.item_popularity[item])
            rec = {
                "product_id": item,
                "name": self.item_names[item] if item < len(self.item_names)
                else f"item_{item}",
                "department": dept,
                "category": cat,
                "popularity_score": pop,
                "avg_price": float(s.item_avg_price[item]),
                "total_purchases": int(s.item_purchases[item]),
                "unique_customers": int(s.item_unique_customers[item]),
                "loyalty_score": float(s.item_loyalty[item]),
                "explanation": self._explain(item, pop, cat),
            }
            if scores is not None:
                rec["score"] = float(np.atleast_1d(scores)[rank])
            out.append(rec)
        return out

    def _explain(self, item: int, pop: float, cat: Optional[str]) -> str:
        """Human-readable recommendation explanation."""
        parts = []
        if pop > 0.5:
            parts.append("a customer favorite")
        elif pop > 0.2:
            parts.append("popular with shoppers")
        if cat:
            parts.append(f"from the {cat} category")
        if self.store.item_loyalty[item] > 0.3:
            parts.append("frequently repurchased")
        return ("Recommended because it is " + " and ".join(parts)
                if parts else "Recommended based on your purchase history")

    @staticmethod
    def normalize_metric(values, lo: float = 0.0, hi: float = 1.0):
        """Min-max range normalization."""
        v = np.asarray(values, np.float64)
        vmin, vmax = v.min(), v.max()
        if vmax - vmin < 1e-12:
            return np.full_like(v, (lo + hi) / 2)
        return lo + (v - vmin) * (hi - lo) / (vmax - vmin)

    def preprocess_for_model(self, user_id: int,
                             at_ts: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pack one user's context into model-input arrays (host arrays;
        the server moves them to its device)."""
        s = self.store
        ts = at_ts if at_ts is not None else int(s.user_last_ts[user_id])
        hour, day, month, doy = temporal_features(np.asarray([ts]))
        return {
            "user_ids": np.asarray([user_id], np.int32),
            "hour": hour, "day": day, "month": month, "day_of_year": doy,
        }
