"""Leave-one-out evaluation: the sampled protocol.

Port of ``ncf_tpu/evals/evaluate.py``.  For each eval user the held-out
positive is ranked against N negatives sampled outside the user's full
history, and HR@k / NDCG@k / MRR@k / MAP@k are averaged over users.

The candidate sets are built once on the host (exact exclusion) and
scored in fixed-size user blocks.  ``evaluate`` is the host loop over
blocks (one rank copy a block); ``DeviceEvaluator`` moves the padded
blocks to the device once and keeps every block's ranks there, with one
copy to the host an evaluation.  Scoring goes through the model's
``score_candidates``, whose tower takes the fused kernel B4f on the card
under ``fused_tower: auto`` with bf16 compute.

Where the reference takes ``sharding=`` (a placement over the training
mesh), the port takes ``device=`` and ``mesh=``.  Under a mesh of
several ranks the padded user blocks are split evenly over the ranks, so
every rank makes the same number of collective calls; each rank scores
its blocks with its parts of the params (the lookups of row-sharded
tables go through the exchange, which the trainer registers), and the
ranks are gathered over the world once an evaluation.  The metrics are
those of the single-device evaluator on the same params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ncf_tpu_torch.data.interactions import Interactions
from ncf_tpu_torch.data.sampler import sample_eval_negatives
from ncf_tpu_torch.data.synthetic import temporal_features
from ncf_tpu_torch.evals.metrics import positive_ranks
from ncf_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class EvalSet:
    """Static eval candidate sets: one positive + N negatives per user."""

    users: np.ndarray          # int32 [U]
    candidates: np.ndarray     # int32 [U, 1+N]; column 0 is the positive
    temporal: Optional[Dict[str, np.ndarray]] = None  # per user, each [U]

    @classmethod
    def build(
        cls,
        full: Interactions,
        eval_users: np.ndarray,
        eval_items: np.ndarray,
        num_negatives: int = 100,
        seed: int = 0,
    ) -> "EvalSet":
        offsets, hist = full.user_histories()
        rng = np.random.default_rng(seed)
        negs = sample_eval_negatives(
            rng, eval_users, offsets, hist, full.num_items, num_negatives)
        cands = np.concatenate([eval_items[:, None], negs],
                               axis=1).astype(np.int32)
        return cls(users=eval_users.astype(np.int32), candidates=cands,
                   temporal=_eval_temporal(full, eval_users))


def _eval_temporal(full: Interactions,
                   eval_users: np.ndarray) -> Dict[str, np.ndarray]:
    """Eval-time temporal context: the features of each eval user's last
    timestamp (the held-out interaction's)."""
    last_ts = np.zeros(full.num_users, np.int64)
    np.maximum.at(last_ts, full.user_ids, full.timestamps)
    hour, day, month, doy = temporal_features(last_ts[eval_users])
    return {"hour": hour, "day": day, "month": month, "day_of_year": doy}


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def evaluate(
    score_fn: Callable,        # (user_ids[B], cand[B,C], temporal) -> [B,C]
    eval_set: EvalSet,
    batch_size: int = 512,
    ks=(1, 5, 10),
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Run the protocol block by block; returns scalar metrics averaged
    over eval users.  The final block is padded to ``batch_size`` rows (as
    the reference pads to its compiled shape) and the padding is cut from
    the ranks."""
    dev = resolve_device(device)
    U = len(eval_set.users)
    B = min(batch_size, U)
    all_ranks = []
    for start in range(0, U, B):
        sl = slice(start, min(start + B, U))
        users = eval_set.users[sl]
        cands = eval_set.candidates[sl]
        temporal = ({k: v[sl] for k, v in eval_set.temporal.items()}
                    if eval_set.temporal else None)
        n = len(users)
        if n < B:
            pad = B - n
            users = np.concatenate([users, users[:1].repeat(pad)])
            cands = np.concatenate([cands, cands[:1].repeat(pad, axis=0)])
            if temporal:
                temporal = {k: np.concatenate([v, v[:1].repeat(pad)])
                            for k, v in temporal.items()}
        with torch.no_grad():
            scores = score_fn(_tensor(users, dev), _tensor(cands, dev),
                              {k: _tensor(v, dev) for k, v in
                               temporal.items()} if temporal else None)
            all_ranks.append(positive_ranks(scores).cpu().numpy()[:n])
    return metrics_from_ranks(np.concatenate(all_ranks), ks)


def metrics_from_ranks(ranks: np.ndarray, ks=(1, 5, 10)) -> Dict[str, float]:
    """Scalar leave-one-out metrics from per-user positive ranks."""
    out: Dict[str, float] = {}
    for k in ks:
        hit = ranks < k
        out[f"hr@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float(
            np.where(hit, 1.0 / np.log2(ranks + 2.0), 0.0).mean())
        rr = np.where(hit, 1.0 / (ranks + 1.0), 0.0)
        out[f"mrr@{k}"] = float(rr.mean())
        out[f"map@{k}"] = float(rr.mean())
    out["mean_rank"] = float(ranks.mean())
    out["num_eval_users"] = float(len(ranks))
    return out


def sample_eval_users(eval_users: np.ndarray, eval_items: np.ndarray,
                      max_users: int, seed: int = 0):
    """Deterministic (seeded, sorted) subsample of the eval population
    (``cfg.data.eval_user_sample``); all users when ``max_users <= 0`` or
    the population is no larger."""
    if max_users <= 0 or len(eval_users) <= max_users:
        return eval_users, eval_items
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(eval_users), size=max_users, replace=False)
    sel.sort()
    return eval_users[sel], eval_items[sel]


class DeviceEvaluator:
    """Device-resident leave-one-out evaluator.

    The padded candidate sets are stacked ``[nb, B, ...]`` and moved to
    ``device`` once (the eval set is static for a training run).  Each
    evaluation loops over the ``nb`` blocks on the device, writes each
    block's ranks into one device tensor and copies the ``[U]`` ranks to
    the host once.
    """

    def __init__(
        self,
        model,
        cfg,                        # ModelConfig
        eval_set: EvalSet,
        batch_size: int = 2048,
        item_dept=None,
        item_cat=None,
        user_history=None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.U = len(eval_set.users)
        B = int(min(batch_size, self.U))
        nb = -(-self.U // B)
        parts = 1 if self.mesh is None else self.mesh.size
        nb = -(-nb // parts) * parts            # every rank the same count
        pad = nb * B - self.U
        mine = slice(None)
        if self.mesh is not None:
            per = nb // parts
            mine = slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

        def _stack(x):
            x = np.asarray(x)
            if pad:
                x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
            return _tensor(x.reshape((nb, B) + x.shape[1:])[mine],
                           self.device)

        self._users = _stack(eval_set.users)
        self._cands = _stack(eval_set.candidates)
        self._temporal = ({k: _stack(v) for k, v in eval_set.temporal.items()}
                          if eval_set.temporal else None)
        self._consts = {k: _tensor(v, self.device) for k, v in (
            ("dept", item_dept), ("cat", item_cat), ("hist", user_history))
            if v is not None}

    def _blocks(self, params, fn):
        """``fn(scores)`` of every block of this rank, stacked ``[nb, B,
        ...]`` on the device, then gathered over the mesh's ranks."""
        hist = self._consts.get("hist")
        outs = []
        with torch.no_grad():
            for i in range(self._users.shape[0]):
                u = self._users[i]
                temporal = ({k: v[i] for k, v in self._temporal.items()}
                            if self._temporal else None)
                kwargs = {}
                if hist is not None:
                    kwargs["history"] = hist[u.long()]
                scores = self.model.score_candidates(
                    params, self.cfg, u, self._cands[i], temporal,
                    self._consts.get("dept"), self._consts.get("cat"),
                    **kwargs)
                outs.append(fn(scores))
        out = torch.stack(outs)
        out = out.reshape((-1,) + tuple(out.shape[2:]))
        if self.mesh is not None:
            out = self.mesh.all_gather(out, "world")
        return out.cpu().numpy()[: self.U]

    def ranks(self, params) -> np.ndarray:
        """Per-user 0-based rank of the positive; one copy to the host."""
        return self._blocks(params, lambda s: positive_ranks(s).to(
            torch.int32))

    def scores(self, params) -> np.ndarray:
        """Per-user candidate scores [U, 1+N] (the positive in column
        0), as ``ranks`` ranks them."""
        return self._blocks(params, lambda s: s.to(torch.float32))

    def __call__(self, params, ks=(1, 5, 10)) -> Dict[str, float]:
        return metrics_from_ranks(self.ranks(params), ks)


def make_score_fn(model, params, cfg, item_dept=None, item_cat=None,
                  user_history=None, device: DeviceLike = None):
    """The candidate scorer for ``evaluate``: ``score(users [B], cands
    [B, C], temporal) -> [B, C]`` logits on ``device``.
    ``user_history``: an optional [num_users, H] context table (sequence
    models), whose rows are gathered per eval block."""
    dev = resolve_device(device)
    consts = {k: _tensor(v, dev) for k, v in (
        ("dept", item_dept), ("cat", item_cat), ("hist", user_history))
        if v is not None}

    def score(users, cands, temporal):
        kwargs = {}
        if "hist" in consts:
            kwargs["history"] = consts["hist"][users.long()]
        with torch.no_grad():
            return model.score_candidates(
                params, cfg, users, cands, temporal,
                consts.get("dept"), consts.get("cat"), **kwargs)

    return score
