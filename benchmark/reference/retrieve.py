"""The comparison that decides ``correct`` in a retrieval cell.

Once the window has closed and the program is freed, the reference
makes the weights again from the seed, works out the user queries, the
item vectors and the item bias under the call's temporal context
itself (``model.py``), and scores every item for each user of a sample
of the window's calls drawn from the seed.  Each served answer is then
judged by what it says:

- ``score_gap``: the largest gap between a served score (a probability)
  and the sigmoid of the reference's logit of the served item;
- ``rank_gap``: the largest amount, in logits, by which the reference's
  logit of the item served in slot j lies below the reference's j-th
  best logit over the items the request allows;
- ``invalid``: served slots that name no item, repeat an item of the
  same answer, or name an item the request excludes (limit 0).

``control`` puts the reference computed one precision below the
configuration's (``model.CONTROL``) in the program's place: its answers
are the top-k of its own logits, with their sigmoid as scores.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import model as ref


class Reference:
    """The reference's tables for one cell (queries are per call)."""

    def __init__(self, params, m, temporal_ctx, item_dept, item_cat,
                 prec: ref.Prec = ref.EXACT):
        ref.no_tf32()
        self.params, self.m, self.prec = params, m, prec
        with torch.no_grad():
            self.v = ref.item_vectors(params, m)
            self.bias = ref.item_bias(params, m, temporal_ctx, item_dept,
                                      item_cat, prec)

    @torch.no_grad()
    def logits(self, users: np.ndarray) -> torch.Tensor:
        dev = self.v.device
        q = ref.user_queries(self.params, self.m,
                             torch.as_tensor(users, device=dev))
        return ref.scores(q, self.v, self.bias, self.prec)

    @torch.no_grad()
    def answer(self, users: np.ndarray, k: int,
               exclude: Optional[np.ndarray]):
        """(scores [B, k] f32 probabilities, ids [B, k] int32): this
        precision's own top-k, the excluded items left out."""
        s = allowed(self.logits(users), exclude)
        vals, idx = torch.topk(s, k, dim=1)
        return (torch.sigmoid(vals).float().cpu().numpy(),
                idx.to(torch.int32).cpu().numpy())


def allowed(logits: torch.Tensor, exclude: Optional[np.ndarray]
            ) -> torch.Tensor:
    """The logits with each row's excluded items at -inf."""
    if exclude is None:
        return logits
    ex = torch.as_tensor(exclude, device=logits.device).long()
    keep = ex >= 0
    rows = torch.arange(ex.shape[0], device=logits.device)[:, None]
    out = logits.clone()
    out[rows.expand_as(ex)[keep], ex[keep]] = float("-inf")
    return out


@torch.no_grad()
def judge(truth: torch.Tensor, served_scores: np.ndarray,
          served_ids: np.ndarray, exclude: Optional[np.ndarray]
          ) -> Dict[str, float]:
    """The numbers of one call's answers against the exact logits
    ``truth`` [B, I]."""
    dev = truth.device
    B, k = served_ids.shape
    I = truth.shape[1]
    ids = torch.as_tensor(served_ids, device=dev).long()
    in_range = (ids >= 0) & (ids < I)
    safe = ids.clamp(0, I - 1)
    s = allowed(truth, exclude)
    best = torch.topk(s, k, dim=1).values.double()
    got = truth.gather(1, safe).double()
    bad = ~in_range | ~torch.isfinite(s.gather(1, safe))
    srt = safe.sort(dim=1).values
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]
    served = torch.as_tensor(served_scores, device=dev).double()
    score_gap = (served - torch.sigmoid(got)).abs()
    rank_gap = (best - got).clamp(min=0)
    ok = ~bad
    return {"score_gap": float(score_gap[ok].max()) if ok.any() else 0.0,
            "rank_gap": float(rank_gap[ok].max()) if ok.any() else 0.0,
            "invalid": float(bad.sum())}


def worst(rows) -> Dict[str, float]:
    """The largest of each number over the judged calls."""
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
