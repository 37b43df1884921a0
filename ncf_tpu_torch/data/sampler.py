"""Negative sampling: on the device for training, on the host for eval.

Port of ``ncf_tpu/data/sampler.py``: ``make_sampling_cdf``,
``_inverse_cdf``, ``sample_negatives`` (iid, with its plain ``history``
variant) and ``sample_negatives_stratified`` on the device; and the host
NumPy eval sampler ``sample_eval_negatives`` with ``_membership`` and
``padded_histories``, which draw the same candidates as the reference's
from the same ``np.random.Generator`` (natively where the port's copy of
the C++ loader builds, else by the same vectorised rejection loop).

Randomness comes from an explicit ``torch.Generator`` on the sampler's
device.  Its numbers are not ``jax.random``'s, so every sampler also takes
the random numbers themselves (``u``; ``sorted_u`` and ``rot`` for the
stratified one): given the same numbers and CDF, the ids equal the
reference's exactly.

With a CDF every weighted draw goes through kernel B1
(``ops/sampler.py::tree_sample_negatives``): the kernel on the card, its
plain version on the CPU, as ``sampler.py:137`` and ``:193`` route the
draws to the Pallas kernel on a TPU.  The history variant draws through B1
with no positive to reject and applies the membership test after it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ncf_tpu_torch.ops.sampler import tree_sample_negatives


def make_sampling_cdf(weights, device=None) -> torch.Tensor:
    """f32 cumulative distribution for inverse-CDF sampling; ``weights``
    need not be normalized.  The cumulative sum is taken on the CPU, in
    order (torch's, which need not round like ``jnp.cumsum``), and then
    moved to ``device``: a float scan on the card adds in an order that
    can change from run to run."""
    if not isinstance(weights, torch.Tensor):
        weights = torch.from_numpy(np.asarray(weights, np.float32))
    target = weights.device if device is None else device
    cdf = torch.cumsum(weights.detach().to("cpu", torch.float32), dim=0)
    return (cdf / cdf[-1]).to(target)


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``#{i : cdf[i] <= u}`` clipped to ``num_items - 1``: int32 of
    ``u``'s shape (the reference's exact inverse-CDF transform)."""
    num_items = cdf.shape[0]
    no_pos = torch.full((u.numel(),), -1, dtype=torch.int32, device=u.device)
    flat = tree_sample_negatives(u.reshape(1, -1).to(torch.float32), no_pos,
                                 cdf, num_items)
    return flat.reshape(u.shape)


def _uniform(gen: Optional[torch.Generator], shape, device,
             low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    if low != 0.0 or high != 1.0:
        u = u * (high - low) + low
    return u


def sample_negatives(
    gen: Optional[torch.Generator],
    pos_items: torch.Tensor,            # int [B], the positive of each row
    num_items: int,
    num_negatives: int,
    cdf: Optional[torch.Tensor] = None,      # f32 [num_items]
    history: Optional[torch.Tensor] = None,  # int [B, H] padded with -1
    num_rounds: int = 2,
    u: Optional[torch.Tensor] = None,        # f32 [R, B, NEG] or [R, B*NEG]
) -> torch.Tensor:
    """``[B, num_negatives]`` int32 negatives: each slot draws
    ``num_rounds`` candidates and keeps the first that is neither the
    row's positive nor (with ``history``) in the row's history, else the
    last draw.  Without a CDF the draws are uniform ids from ``gen``."""
    B = pos_items.shape[0]
    dev = pos_items.device
    pos = pos_items.to(torch.int32)
    if cdf is None:
        cands = torch.randint(0, num_items, (num_rounds, B, num_negatives),
                              generator=gen, device=dev, dtype=torch.int32)
    else:
        if u is None:
            u = _uniform(gen, (num_rounds, B * num_negatives), dev)
        if history is None:
            return tree_sample_negatives(u, pos, cdf, num_items)
        cands = _inverse_cdf(cdf, u).reshape(num_rounds, B, num_negatives)
    ok = cands != pos[None, :, None]
    if history is not None:
        hit = (cands[..., None] == history.to(torch.int32)[None, :, None, :]
               ).any(-1)
        ok = ok & ~hit
    pick = cands[num_rounds - 1]
    for r in range(num_rounds - 2, -1, -1):
        pick = torch.where(ok[r], cands[r], pick)
    return pick


def stratified_uniforms(gen: Optional[torch.Generator], n: int,
                        device=None) -> torch.Tensor:
    """``n`` sorted uniforms without a sort: normalised cumulative sums of
    ``n + 1`` exponential spacings (``sampler.py:124-128``).  The spacings
    are summed in fixed point (int64, units of 2^-32), exact in any order:
    a float scan on the card adds in an order that can change from run to
    run, and the step must give the same negatives every time."""
    u = _uniform(gen, (n + 1,), device, 1e-7, 1.0)
    spacing = torch.round(-torch.log(u).double() * 2.0 ** 32).long()
    s = torch.cumsum(spacing, dim=0).double()
    return (s[:n] / s[n]).float()


def sample_negatives_stratified(
    gen: Optional[torch.Generator],
    pos_items: torch.Tensor,            # int [B]
    num_items: int,
    num_negatives: int,
    cdf: Optional[torch.Tensor] = None,
    num_rounds: int = 2,
    sorted_u: Optional[torch.Tensor] = None,   # f32 [B * NEG], sorted
    rot: Optional[int] = None,                 # in [0, B * NEG)
) -> torch.Tensor:
    """Stratified sorted negatives (``sampler.py:80``): one pooled sorted
    sample of ``B * num_negatives`` draws, assigned to (row, slot) cells by
    a strided rotation; a collision with the row's positive advances 32*k
    places in the pooled sample for k < ``num_rounds``."""
    B = pos_items.shape[0]
    N = B * num_negatives
    dev = pos_items.device
    if sorted_u is None:
        sorted_u = stratified_uniforms(gen, N, dev)
    if cdf is None:
        pooled = torch.clamp((sorted_u * num_items).to(torch.int32),
                             0, num_items - 1)
    else:
        pooled = _inverse_cdf(cdf, sorted_u)
    if rot is None:          # a device scalar: no host sync per step
        rot = torch.randint(0, N, (), generator=gen, device=dev)
    # cell (b, s) takes pooled[(s*B + b + rot) mod N]: jnp.roll(pooled,
    # -rot) read column-major, as an index instead of a host-side shift
    cell = torch.arange(N, device=dev).reshape(num_negatives, B).T
    pos = pos_items.to(torch.int32)[:, None]
    negs = pooled[(cell + rot) % N]
    for k in range(1, num_rounds):
        nxt = pooled[(cell + rot + 32 * k) % N]
        negs = torch.where(negs == pos, nxt, negs)
    return negs


# ------------------------------------------------------- host eval sampling

def sample_eval_negatives(
    rng: np.random.Generator,
    eval_users: np.ndarray,        # int32 [U']
    history_offsets: np.ndarray,   # int64 [num_users + 1] CSR offsets
    history_items: np.ndarray,     # int32 [N] sorted within each user
    num_items: int,
    num_negatives: int = 100,
) -> np.ndarray:
    """``[U', num_negatives]`` int32: for each eval user, items drawn
    uniformly from outside the user's full history.  The native sampler
    where it is built (exact, seeded from ``rng``); otherwise NumPy
    rejection: draw, test membership by a binary search of the sorted
    history, draw again only the colliding entries (at most 100 rounds)."""
    from ncf_tpu_torch import native

    if native.available():
        seed = int(rng.integers(0, 2**62))
        return native.sample_negatives_exact(
            eval_users, eval_users * 0 - 1,  # no extra positive to exclude
            np.ones(num_items, np.float64),
            history_offsets, history_items, num_negatives, seed=seed)

    U = len(eval_users)
    rows = np.repeat(np.arange(U), num_negatives)
    draw = rng.integers(0, num_items, size=U * num_negatives).astype(np.int32)
    bad = _membership(eval_users[rows], draw, history_offsets, history_items)
    attempts = 0
    while bad.any() and attempts < 100:
        n_bad = int(bad.sum())
        draw[bad] = rng.integers(0, num_items, size=n_bad).astype(np.int32)
        bad_idx = np.nonzero(bad)[0]
        still = _membership(eval_users[rows[bad_idx]], draw[bad_idx],
                            history_offsets, history_items)
        bad = np.zeros_like(bad)
        bad[bad_idx[still]] = True
        attempts += 1
    return draw.reshape(U, num_negatives)


def _membership(users: np.ndarray, items: np.ndarray, offsets: np.ndarray,
                sorted_items: np.ndarray) -> np.ndarray:
    """Whether each ``items[j]`` lies in user ``users[j]``'s sorted history
    segment: a binary search, vectorised over the queries."""
    lo = offsets[users]
    hi = offsets[users + 1]
    res = np.zeros(len(users), bool)
    left = lo.copy()
    right = hi.copy()
    while True:
        active = left < right
        if not active.any():
            break
        mid = (left + right) // 2
        vals = np.where(
            active, sorted_items[np.minimum(mid, len(sorted_items) - 1)], 0)
        go_right = active & (vals < items)
        found = active & (vals == items)
        res |= found
        left = np.where(go_right, mid + 1, left)
        right = np.where(active & ~go_right & ~found, mid, right)
        left = np.where(found, right, left)      # end the found queries
    return res


def padded_histories(offsets: np.ndarray, items: np.ndarray,
                     users: np.ndarray, max_len: int) -> np.ndarray:
    """Per-user histories as a dense ``[len(users), max_len]`` int32 array
    padded with -1 (each cut to its first ``max_len`` items)."""
    out = np.full((len(users), max_len), -1, np.int32)
    for r, u in enumerate(users):
        seg = items[offsets[u]:offsets[u + 1]][:max_len]
        out[r, :len(seg)] = seg
    return out
