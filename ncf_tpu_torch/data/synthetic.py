"""Vectorized synthetic retail interaction generator.

The port's copy of ``ncf_tpu/data/synthetic.py`` (NumPy only; the port imports nothing
of the JAX package), so both packages build identical arrays from one
seed.

TPU-native re-design of the reference's data platform datagen
(reference: src/data/generators/product_generator.py:8-160,
transaction_generator.py:10-233, loyalty_customer_generator.py:8-147).
The reference generates row-by-row Python dicts destined for BigQuery;
here the same statistical structure is produced as dense NumPy arrays in
one vectorized pass, because the training target is an on-device pipeline,
not a warehouse.

Reproduced structure:
- department/category taxonomy: 9 departments, ~30 categories with
  per-category product-count targets (product_generator.py:37-100);
- hourly visit weights with morning/evening rush peaks
  (transaction_generator.py:27-34);
- Poisson(2.5) basket size clamped to [1, 8]
  (transaction_generator.py:185-186);
- per-category price ranges (transaction_generator.py:37-45);
- per-user category affinities (the reference encodes affinities as
  commonly-bought-together category pairs, transaction_generator.py:17-24;
  here each user draws a Dirichlet preference over categories, which gives
  the learnable user->category signal an NCF model can actually fit);
- within-category Zipf item popularity (real catalogs are heavy-tailed;
  this also exercises the inverse-popularity negative sampler).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ncf_tpu_torch.data.interactions import SECONDS_PER_DAY, Interactions

# 9 departments and their categories with target product-count weights
# (behavioral mirror of product_generator.py:37-100).
TAXONOMY = {
    "FS": [("MTO", 50), ("RTE", 40), ("HOT", 30), ("CLD", 35)],
    "BV": [("FTN", 20), ("COF", 25), ("BEV", 150), ("NRG", 75), ("H2O", 40)],
    "SN": [("CHP", 200), ("CND", 250), ("NUT", 100), ("JRK", 50)],
    "GR": [("PKG", 300), ("DRY", 75), ("FRZ", 100), ("GRC", 150)],
    "TB": [("CIG", 400), ("TOB", 150), ("ECG", 100)],
    "AL": [("BER", 300), ("WIN", 200), ("MLT", 100)],
    "HB": [("OTC", 150), ("PCA", 200), ("HLA", 100)],
    "AT": [("OIL", 75), ("AUT", 150)],
    "GM": [("GEN", 120), ("SEA", 80)],
}

# Hourly visit weights (transaction_generator.py:27-34).
HOURLY_WEIGHTS = np.array(
    [0.2, 0.1, 0.1, 0.1, 0.3, 0.8, 1.5, 2.0, 1.8, 1.2, 1.0, 1.5,
     2.0, 1.5, 1.0, 1.2, 1.8, 2.0, 1.8, 1.5, 1.2, 0.8, 0.5, 0.3],
    dtype=np.float64,
)

# Category price ranges; categories not listed use the default
# (transaction_generator.py:37-45).
PRICE_RANGES = {
    "MTO": (6.99, 15.99), "HOT": (4.99, 12.99), "BEV": (1.99, 4.99),
    "CHP": (1.49, 5.99), "CND": (0.99, 3.99), "CIG": (7.99, 12.99),
    "BER": (8.99, 24.99), "WIN": (8.99, 24.99),
}
DEFAULT_PRICE_RANGE = (1.49, 9.99)


def _catalog(num_items: int, rng: np.random.Generator):
    """Assign items to (dept, category) proportionally to taxonomy weights,
    with per-item Zipf popularity within category."""
    cats, depts, weights = [], [], []
    for d_idx, (dept, cat_list) in enumerate(TAXONOMY.items()):
        for (cat, w) in cat_list:
            cats.append(cat)
            depts.append(d_idx)
            weights.append(w)
    weights = np.asarray(weights, np.float64)
    probs = weights / weights.sum()
    item_cat = rng.choice(len(cats), size=num_items, p=probs).astype(np.int32)
    item_dept = np.asarray(depts, np.int32)[item_cat]

    # Within-category Zipf rank popularity.
    item_pop = np.zeros(num_items, np.float64)
    for c in range(len(cats)):
        idx = np.nonzero(item_cat == c)[0]
        if len(idx) == 0:
            continue
        ranks = rng.permutation(len(idx)) + 1
        item_pop[idx] = 1.0 / ranks**0.8
    item_pop /= item_pop.sum()

    # Price per item from its category range.
    lo = np.array([PRICE_RANGES.get(cats[c], DEFAULT_PRICE_RANGE)[0] for c in item_cat])
    hi = np.array([PRICE_RANGES.get(cats[c], DEFAULT_PRICE_RANGE)[1] for c in item_cat])
    item_price = (lo + rng.random(num_items) * (hi - lo)).astype(np.float32)

    cat_names = list(cats)
    dept_names = list(TAXONOMY.keys())
    return item_cat, item_dept, item_pop, item_price, cat_names, dept_names


def generate_interactions(
    num_users: int = 8031,
    num_items: int = 366,
    num_days: int = 90,
    avg_txns_per_user: int = 12,
    seed: int = 0,
    affinity_concentration: float = 0.3,
) -> Interactions:
    """Generate a synthetic interaction log.

    Each user draws a Dirichlet(alpha) preference over categories
    (lower ``affinity_concentration`` => sharper preferences => more
    learnable signal), visits at hours drawn from HOURLY_WEIGHTS, and buys
    Poisson(2.5)-clamped-[1,8] items per visit, chosen by
    user-category-preference x item-popularity.
    """
    rng = np.random.default_rng(seed)
    item_cat, item_dept, item_pop, item_price, cat_names, dept_names = _catalog(
        num_items, rng)
    num_cats = len(cat_names)

    # Per-user category preferences.
    user_pref = rng.dirichlet(
        np.full(num_cats, affinity_concentration), size=num_users
    )  # [U, C]

    # Visits per user ~ Poisson(avg), at least 1.
    visits = np.maximum(rng.poisson(avg_txns_per_user, size=num_users), 1)
    visit_user = np.repeat(np.arange(num_users, dtype=np.int64), visits)
    n_visits = len(visit_user)

    # Visit timestamps: uniform day + weighted hour + uniform min/sec.
    day = rng.integers(0, num_days, n_visits)
    hour_p = HOURLY_WEIGHTS / HOURLY_WEIGHTS.sum()
    hour = rng.choice(24, size=n_visits, p=hour_p)
    sec = rng.integers(0, 3600, n_visits)
    visit_ts = day * SECONDS_PER_DAY + hour * 3600 + sec

    # Basket sizes: Poisson(2.5) clamped to [1, 8]
    # (transaction_generator.py:185-186).
    basket = np.clip(rng.poisson(2.5, n_visits), 1, 8)
    row_user = np.repeat(visit_user, basket)
    row_ts = np.repeat(visit_ts, basket)
    n_rows = len(row_user)

    # Item choice: first pick category from user preference, then item from
    # within-category popularity.  Vectorized with Gumbel-max over the
    # [n_rows, C] preference logits and masked popularity logits.
    cat_logits = np.log(user_pref[row_user] + 1e-12)
    g = rng.gumbel(size=(n_rows, num_cats))
    row_cat = np.argmax(cat_logits + g, axis=1).astype(np.int32)

    # Within chosen category, sample item by popularity using per-category
    # cumulative distributions.
    items_by_cat = [np.nonzero(item_cat == c)[0] for c in range(num_cats)]
    cdf_by_cat = []
    for c in range(num_cats):
        idx = items_by_cat[c]
        if len(idx) == 0:
            cdf_by_cat.append(None)
            continue
        p = item_pop[idx]
        cdf_by_cat.append(np.cumsum(p / p.sum()))
    row_item = np.zeros(n_rows, np.int64)
    u01 = rng.random(n_rows)
    nonempty_fallback = np.nonzero(item_pop > 0)[0]
    for c in range(num_cats):
        sel = row_cat == c
        if not sel.any():
            continue
        idx = items_by_cat[c]
        if idx is None or len(idx) == 0:
            row_item[sel] = rng.choice(nonempty_fallback, size=int(sel.sum()))
            continue
        pos = np.searchsorted(cdf_by_cat[c], u01[sel], side="right")
        row_item[sel] = idx[np.minimum(pos, len(idx) - 1)]

    qty = np.maximum(rng.poisson(1.2, n_rows), 1)
    amounts = (item_price[row_item] * qty * 1.06).astype(np.float32)  # 6% tax

    inter = Interactions(
        user_ids=row_user.astype(np.int32),
        item_ids=row_item.astype(np.int32),
        timestamps=row_ts.astype(np.int64),
        amounts=amounts,
        num_users=num_users,
        num_items=num_items,
        user_map={i: i for i in range(num_users)},
        item_map={i: i for i in range(num_items)},
        item_dept=item_dept,
        item_cat=item_cat,
        num_departments=len(dept_names),
        num_categories=num_cats,
    )
    order = np.argsort(inter.timestamps, kind="stable")
    return inter.select(order)


def temporal_features(timestamps: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Decompose unix seconds into (hour[0-24), weekday[0-7), month[0-12),
    day_of_year[0-365)) — the feature set of the reference TemporalEncoding
    (architecture.py:59-94, training_data.py:72-81)."""
    ts = np.asarray(timestamps, np.int64)
    day = ts // SECONDS_PER_DAY
    hour = (ts // 3600) % 24
    weekday = day % 7
    day_of_year = day % 365
    month = np.minimum(day_of_year // 30, 11)
    return (
        hour.astype(np.int32),
        weekday.astype(np.int32),
        month.astype(np.int32),
        day_of_year.astype(np.int32),
    )
