"""MovieLens loaders (ML-100K / ML-1M / ML-25M) for the benchmark configs.

A copy of ``ncf_tpu/data/movielens.py`` over the port's ``Interactions``.

The reference trains on BigQuery retail data (src/model/trainer.py:180-205);
BASELINE.json defines our benchmark configs on MovieLens, so this module
loads the standard MovieLens file formats from a local directory.  No
network access is performed — if the files are absent, callers fall back to
the synthetic generator (ncf_tpu_torch.data.synthetic).

Supported layouts (auto-detected from files present in ``path``):
- ML-100K: ``u.data``       (tab-separated  user  item  rating  ts)
- ML-1M:   ``ratings.dat``  (``user::item::rating::ts``)
- ML-25M:  ``ratings.csv``  (``userId,movieId,rating,timestamp`` header)

Genre metadata (``u.item`` / ``movies.dat`` / ``movies.csv``) is mapped to
the framework's department/category item features when available.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ncf_tpu_torch.data.interactions import Interactions

GENRES_1M = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]


def available(path: str) -> bool:
    return any(
        os.path.exists(os.path.join(path, f))
        for f in ("u.data", "ratings.dat", "ratings.csv")
    )


def _load_genres(path: str) -> Tuple[Optional[Dict], Optional[Dict]]:
    """Returns (item->primary-genre-name, item->genre-name) maps; the primary
    genre doubles as the 'department', the full first genre as 'category'."""
    movies_dat = os.path.join(path, "movies.dat")
    movies_csv = os.path.join(path, "movies.csv")
    u_item = os.path.join(path, "u.item")
    cat: Dict = {}
    if os.path.exists(movies_dat):
        with open(movies_dat, encoding="latin-1") as f:
            for line in f:
                parts = line.rstrip("\n").split("::")
                if len(parts) >= 3:
                    cat[int(parts[0])] = parts[2].split("|")[0]
    elif os.path.exists(movies_csv):
        import csv
        with open(movies_csv, encoding="utf-8") as f:
            reader = csv.reader(f)
            next(reader, None)
            for row in reader:
                if len(row) >= 3:
                    cat[int(row[0])] = row[2].split("|")[0]
    elif os.path.exists(u_item):
        with open(u_item, encoding="latin-1") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 24:
                    flags = [int(x) for x in parts[5:24]]
                    primary = flags.index(1) if 1 in flags else 0
                    name = (["Unknown"] + GENRES_1M)[primary] if primary < 19 else "Unknown"
                    cat[int(parts[0])] = name
    if not cat:
        return None, None
    return cat, cat


def load(path: str, implicit_threshold: float = 0.0) -> Interactions:
    """Load a MovieLens directory as an implicit-feedback Interactions log.

    ``implicit_threshold``: keep ratings >= threshold (0 keeps everything —
    the standard implicit NCF setup treats every rating as a positive).
    """
    users = items = ratings = ts = None
    if os.path.exists(os.path.join(path, "u.data")):
        raw = np.loadtxt(os.path.join(path, "u.data"), dtype=np.int64)
        users, items, ratings, ts = raw[:, 0], raw[:, 1], raw[:, 2].astype(np.float32), raw[:, 3]
    elif os.path.exists(os.path.join(path, "ratings.dat")):
        rows = []
        with open(os.path.join(path, "ratings.dat"), encoding="latin-1") as f:
            for line in f:
                p = line.rstrip("\n").split("::")
                if len(p) == 4:
                    rows.append((int(p[0]), int(p[1]), float(p[2]), int(p[3])))
        arr = np.array(rows)
        users, items = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64)
        ratings, ts = arr[:, 2].astype(np.float32), arr[:, 3].astype(np.int64)
    elif os.path.exists(os.path.join(path, "ratings.csv")):
        import csv
        u_l, i_l, r_l, t_l = [], [], [], []
        with open(os.path.join(path, "ratings.csv")) as f:
            reader = csv.reader(f)
            next(reader, None)
            for row in reader:
                u_l.append(int(row[0])); i_l.append(int(row[1]))
                r_l.append(float(row[2])); t_l.append(int(float(row[3])))
        users = np.asarray(u_l, np.int64); items = np.asarray(i_l, np.int64)
        ratings = np.asarray(r_l, np.float32); ts = np.asarray(t_l, np.int64)
    else:
        raise FileNotFoundError(f"no MovieLens ratings file found under {path}")

    if implicit_threshold > 0:
        keep = ratings >= implicit_threshold
        users, items, ratings, ts = users[keep], items[keep], ratings[keep], ts[keep]

    dept_map, cat_map = _load_genres(path)
    return Interactions.from_raw(
        users, items, ts, amounts=ratings, item_dept=dept_map, item_cat=cat_map)
