"""The benchmark's traffic generators, driven by the mixes beside this
file (``<traffic>.json``) and by ``--seed``.

Every draw comes from a ``torch.Generator`` seeded from ``--seed`` and a
tag, on the device the cell runs on, in a few large calls: the same seed
gives the same inputs, and every seed gives the same sizes.  The
program under test receives only what these functions return.

Copied in spirit from ``chip_smoke.py::_big_setup`` (an active pool of
users, Zipf popularity over a seeded order of the items, the
inverse-popularity negative distribution); the shapes of each mix are
its JSON file's.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import torch

SECONDS_PER_DAY = 86400


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each kind of draw, from ``--seed``."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2 ** 63)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def zipf_cdf(n: int, exponent: float, gen: torch.Generator,
             device) -> torch.Tensor:
    """f64 CDF over ``n`` ids whose popularity falls as ``rank**-exponent``,
    the ranks in a seeded order (so popular ids are spread over the
    table).  The sum is taken on the host, in order: a float scan on the
    card adds in an order that can change from run to run, and the same
    seed has to give the program and the reference the same inputs, bit
    for bit."""
    order = torch.randperm(n, generator=gen, device=device).cpu()
    w = torch.arange(1, n + 1, dtype=torch.float64).pow(-float(exponent))
    cdf = torch.cumsum(w[order], 0)
    return (cdf / cdf[-1]).to(device)


def draw(cdf: torch.Tensor, shape, gen: torch.Generator) -> torch.Tensor:
    """int64 ids of ``shape`` drawn from the CDF."""
    u = torch.rand(shape, generator=gen, device=cdf.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def distinct_rows(n_rows: int, width: int, high: int,
                  gen: torch.Generator, device) -> torch.Tensor:
    """int64 ``[n_rows, width]`` ids uniform over ``[0, high)``, distinct
    within each row (a row with a repeat is drawn again)."""
    ids = torch.randint(0, high, (n_rows, width), generator=gen,
                        device=device)
    while True:
        s = ids.sort(dim=1).values
        bad = (s[:, 1:] == s[:, :-1]).any(dim=1)
        n_bad = int(bad.sum())
        if n_bad == 0:
            return ids
        ids[bad] = torch.randint(0, high, (n_bad, width), generator=gen,
                                 device=device)


def taxonomy(num_items: int, num_departments: int, num_categories: int,
             seed: int, device) -> Dict[str, torch.Tensor]:
    """Each item's department and category, uniform from the seed
    (int32 [num_items] each)."""
    gen = generator(seed, "taxonomy", device)
    return {"item_dept": torch.randint(0, num_departments, (num_items,),
                                       generator=gen, device=device,
                                       dtype=torch.int32),
            "item_cat": torch.randint(0, num_categories, (num_items,),
                                      generator=gen, device=device,
                                      dtype=torch.int32)}


# ------------------------------------------------------------ retrieval

def retrieve_calls(mix: Dict, num_users: int, num_items: int, seed: int,
                   device) -> Dict[str, Optional[torch.Tensor]]:
    """The calls of a retrieval mix, cycled through in the window:
    ``users`` int64 [pool_calls, users_per_call], distinct within a
    call and uniform over every user; with ``seen_per_user``,
    ``exclude`` int32 [pool_calls, users_per_call, seen] of items drawn
    by the Zipf popularity (the already-bought items of each user)."""
    gen = generator(seed, "retrieve", device)
    P, B = int(mix["pool_calls"]), int(mix["users_per_call"])
    users = distinct_rows(P, B, num_users, gen, device)
    exclude = None
    H = int(mix.get("seen_per_user", 0))
    if H:
        cdf = zipf_cdf(num_items, mix["item_zipf"], gen, device)
        exclude = draw(cdf, (P, B, H), gen).to(torch.int32)
    return {"users": users, "exclude": exclude}


# ------------------------------------------------------------- training

def interaction_log(mix: Dict, num_users: int, num_items: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """An interaction log: ``n_interactions`` rows of (user, item,
    unix seconds), users and items each by a Zipf popularity over a
    seeded order, seconds uniform over ``days``, sorted by time as a log
    is.  int64 tensors on ``device``."""
    gen = generator(seed, "log", device)
    n = int(mix["n_interactions"])
    users = draw(zipf_cdf(num_users, mix["user_zipf"], gen, device), (n,),
                 gen)
    items = draw(zipf_cdf(num_items, mix["item_zipf"], gen, device), (n,),
                 gen)
    ts = torch.randint(0, int(mix["days"]) * SECONDS_PER_DAY, (n,),
                       generator=gen, device=device)
    ts, order = torch.sort(ts, stable=True)
    return {"user_ids": users[order], "item_ids": items[order],
            "timestamps": ts}


def id_batches(mix: Dict, num_users: int, num_items: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """``pool_batches`` batches of ``batch_size`` rows, stacked
    ``[pool_batches, B]`` int32: users uniform over an active pool of
    ``active_users`` ids spread over every user, items by the Zipf
    popularity, temporal fields uniform in range.  Also ``neg_weights``
    f32 [num_items]: the inverse popularity of the items' expected counts
    over ``cdf_interactions`` interactions, the weights of the negatives'
    distribution."""
    gen = generator(seed, "batches", device)
    P, B = int(mix["pool_batches"]), int(mix["batch_size"])
    active = torch.randperm(num_users, generator=gen, device=device)[
        :int(mix["active_users"])]
    cdf = zipf_cdf(num_items, mix["item_zipf"], gen, device)
    pop = torch.diff(cdf, prepend=cdf.new_zeros(1))
    cols = {
        "user_ids": active[torch.randint(0, active.numel(), (P, B),
                                         generator=gen, device=device)],
        "item_ids": draw(cdf, (P, B), gen),
        "hour": torch.randint(0, 24, (P, B), generator=gen, device=device),
        "day": torch.randint(0, 7, (P, B), generator=gen, device=device),
        "month": torch.randint(0, 12, (P, B), generator=gen, device=device),
        "day_of_year": torch.randint(0, 365, (P, B), generator=gen,
                                     device=device),
    }
    out = {k: v.to(torch.int32) for k, v in cols.items()}
    out["neg_weights"] = (1.0 / (pop * float(mix["cdf_interactions"])
                                 + 1.0)).to(torch.float32)
    return out


def temporal_features(ts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(hour, weekday, month, day of year) of unix seconds, int32: the
    feature set the model reads (a copy of the port's
    ``data/synthetic.py::temporal_features`` arithmetic)."""
    day = ts // SECONDS_PER_DAY
    doy = day % 365
    return {"hour": ((ts // 3600) % 24).to(torch.int32),
            "day": (day % 7).to(torch.int32),
            "month": torch.clamp(doy // 30, max=11).to(torch.int32),
            "day_of_year": doy.to(torch.int32)}


def inverse_popularity(items: torch.Tensor, num_items: int,
                       smoothing: float = 1.0) -> torch.Tensor:
    """f32 weights ``1 / (count + smoothing)`` normalised, of a log's item
    column: the distribution of the negatives."""
    counts = torch.bincount(items.long(), minlength=num_items).double()
    w = 1.0 / (counts + smoothing)
    return (w / w.sum()).to(torch.float32)
