"""The reference's training steps, and the numbers that decide
``correct`` in a training cell.

The reference starts from the weights the benchmark made from the seed
(made again here), takes the same batches (worked out again from the
benchmark's inputs: the device pipeline's permutation and user sort for
a log, the drawn batches otherwise) and draws from its own generator,
seeded as the program's step generator is, in the order the program's
step draws (the negatives' uniforms, the hierarchy's dropout, the
attention weights' dropout, then the tower's: one int32 seed for the
fused tower's Philox masks on the card, one uniform draw a layer on the
CPU's plain tower).  So it takes the same negatives and the same
dropout masks, and it computes every product in f32 from operands
rounded as the configuration's ``compute_dtype`` states (``model.py``),
with autograd's exact gradient of that forward.

The optimizer is written out again too: optax's global-norm clip, L2
decay into the gradient, Adam with bias correction; for the sparse step,
the per-row totals of the touched rows clipped together with the dense
gradients, then rowwise Adagrad with decay on touch.

Compared, per leaf (``worst_gap``: the gap between the program's norm
and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf):

- ``loss_gap``: the first step's loss, relative to the reference's (the
  later steps' losses are printed, not compared: they carry Adam's
  round-off below, and swing fivefold from seed to seed);
- ``grad_gap``: the norm of the first step's gradient as the optimizer
  gets it (clipped, decayed), read from the program's optimizer state
  after one step (Adam's first moment over 1 - b1; a rowwise-Adagrad
  table's accumulator, d times its sum);
- ``change_gap``: the norm of each leaf's change after the checked
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off
  alone), taken at the median leaf (``median_gap``), not the worst: in
  Adam's first steps an element whose gradient is near ``eps`` moves by
  up to the learning rate on a round-off, so the worst leaf is a small
  one whose gap swings tenfold from seed to seed;
- ``table_gap``: the same gap of the embedding tables' change on its
  own, the worse of the two tables (large leaves whose gradients are far
  from ``eps``), so that an update that moves the optimizer's state but
  leaves the rows unchanged, or moves them by the wrong step, is seen;
- ``stray_gap`` (sparse table update only): the norm of the program's
  change over the rows that the reference left unmoved, over the norm of
  the reference's change of that table, the worse of the two: an update
  written to the wrong rows.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import model as ref
from benchmark.reference.philox import keep_mask

TABLES = ("user_emb", "item_emb")
B1, B2, EPS = 0.9, 0.999, 1e-8


def vocab_precompute(m, rows: int) -> bool:
    """The port's branch rule: the vocabulary tables are derived once a
    step when they are smaller than four times the batch's occurrences."""
    return m.num_items + m.num_users <= 4 * rows


def negatives(gen, pos: torch.Tensor, cdf: torch.Tensor, neg: int,
              rounds: int = 2) -> torch.Tensor:
    """iid negatives by the inverse CDF: each slot draws ``rounds``
    uniforms and keeps the first id that is not the row's positive, else
    the last (int64 [B, neg])."""
    B = pos.shape[0]
    u = torch.rand((rounds, B * neg), generator=gen, device=pos.device)
    d = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
    d = d.reshape(rounds, B, neg)
    pick = d[rounds - 1]
    for r in range(rounds - 2, -1, -1):
        pick = torch.where(d[r] != pos.long()[:, None], d[r], pick)
    return pick


def sampling_cdf(w: torch.Tensor, device) -> torch.Tensor:
    """The f32 CDF of weights ``w``, summed in order on the CPU."""
    c = torch.cumsum(w.detach().to("cpu", torch.float32), dim=0)
    return (c / c[-1]).to(device)


class Forward:
    """The training forward of AdvancedNCF under ``candidate_mode:
    joint`` (the configurations' mode), returning logits [B, S]."""

    def __init__(self, m, prec: ref.Prec, fused_tower: bool):
        if m.candidate_mode != "joint" or m.use_sequence:
            raise ValueError("the reference covers joint candidate "
                             "attention without the sequence path")
        self.m, self.prec, self.fused = m, prec, fused_tower

    def _drop(self, gen):
        keep = 1.0 - self.m.dropout

        def drop(x):
            mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
            return torch.where(mask, x / keep, torch.zeros_like(x))
        return drop

    def _tower_drops(self, gen, rows: int, dev):
        rate = self.m.dropout
        if not self.fused:
            return [self._drop(gen)] * len(self.m.mlp_hidden_dims)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=dev, dtype=torch.int32)
        drops = []
        for i, h in enumerate(self.m.mlp_hidden_dims):
            mask = keep_mask(seed, i, rows, h, rate)
            drops.append(lambda y, mask=mask: torch.where(
                mask, y * (1.0 / (1.0 - rate)), torch.zeros_like(y)))
        return drops

    def __call__(self, P, batch, items, gen, item_dept, item_cat,
                 rows: Optional[Dict[str, torch.Tensor]] = None):
        m, act = self.m, self.prec.act
        B, S = items.shape
        dmf, D = m.mf_dim, m.mlp_dim
        drop = self._drop(gen)
        users = batch["user_ids"].long()
        if vocab_precompute(m, B * S):
            user_t = torch.cat([
                ref.layer_norm(P["mf_norm"], P["user_emb"][:, :dmf]),
                ref.layer_norm(P["mlp_norm"], P["user_emb"][:, dmf:])], 1)
            item_mlp_t = ref.layer_norm(P["mlp_norm"],
                                        P["item_emb"][:, dmf:]) \
                + ref.hierarchy(P["category"], item_dept, item_cat,
                                self.prec, drop)
            item_t = torch.cat([ref.layer_norm(P["mf_norm"],
                                               P["item_emb"][:, :dmf]),
                                item_mlp_t], 1)
            uf = ref.rnd(user_t, act)[users]
            itf = ref.rnd(item_t, act)[items.long()]
            u_mf, u_mlp = uf[:, :dmf], uf[:, dmf:]
            i_mf, i_mlp = itf[..., :dmf], itf[..., dmf:]
            mf_vec = ref.rnd(u_mf[:, None, :] * i_mf, act)
        else:
            uf = rows["user_rows"] if rows else P["user_emb"][users]
            itf = rows["item_rows"] if rows else P["item_emb"][items.long()]
            u_mf = ref.layer_norm(P["mf_norm"], uf[:, :dmf])
            u_mlp = ref.layer_norm(P["mlp_norm"], uf[:, dmf:])
            i_mf = ref.layer_norm(P["mf_norm"], itf[..., :dmf])
            i_mlp = ref.layer_norm(P["mlp_norm"], itf[..., dmf:])
            flat = items.long().reshape(-1)
            i_mlp = i_mlp + ref.hierarchy(
                P["category"], item_dept[flat], item_cat[flat], self.prec,
                drop).reshape(B, S, D)
            mf_vec = u_mf[:, None, :] * i_mf
        mf_pred = ref.dense(P["mf_out"], mf_vec, act)              # [B,S,1]
        t_vec = ref.temporal(P["temporal"], batch["hour"], batch["day"],
                             batch["month"], batch["day_of_year"])
        a = P["attn"]
        H = m.num_heads
        hd = D // H
        q = ref.dense(a["q"], u_mlp, act)
        k = ref.dense(a["k"], i_mlp, act)
        v = ref.dense(a["v"], i_mlp, act)
        sc = (q[:, None, :] * k).reshape(B, S, H, hd).sum(-1) \
            / math.sqrt(hd)
        w = drop(torch.softmax(sc, dim=1))
        pooled = (w[..., None] * v.reshape(B, S, H, hd)).sum(dim=1)
        attn = ref.dense(a["o"], pooled.reshape(B, D), act)
        comb = torch.cat([attn, t_vec], dim=-1)
        h = ref.tower(P["mlp"], comb, act,
                      self._tower_drops(gen, B, comb.device))
        mlp_pred = ref.dense(P["mlp_out"], h)[:, None, :].expand(B, S, 1)
        both = torch.cat([mf_pred, mlp_pred], dim=-1)
        return ref.dense(P["final"], both)[..., 0]


def bce(logits: torch.Tensor) -> torch.Tensor:
    t = torch.zeros_like(logits)
    t[:, 0] = 1.0
    return F.binary_cross_entropy_with_logits(logits, t)


class Reference:
    """The reference's training run: ``step(batch)`` takes one step and
    returns its loss; ``first_grad`` holds each leaf's first gradient as
    the optimizer got it, ``params`` the leaves (by path).  ``fault``
    (the batch and the slots' items in, the same out) and ``table_fault``
    plant a fault for the calibration: ``"frozen"``, the tables' optimizer
    state moves and their rows do not; ``"shifted"``, each touched row's
    update is written to the next row (sparse update)."""

    def __init__(self, m, t, params, consts, gen: torch.Generator,
                 sparse: bool, fused_tower: bool,
                 prec: ref.Prec = ref.EXACT,
                 fault: Optional[Callable] = None,
                 table_fault: Optional[str] = None):
        ref.no_tf32()
        self.m, self.t, self.gen, self.sparse = m, t, gen, sparse
        self.params = dict(weights.leaves(params))
        self.tree = params
        self.cdf = consts["cdf"]
        self.dept, self.cat = consts["item_dept"], consts["item_cat"]
        self.forward = Forward(m, prec, fused_tower)
        self.fault = fault
        if table_fault not in (None, "frozen", "shifted"):
            raise ValueError(f"unknown table fault {table_fault!r}")
        self.table_fault = table_fault
        adam = [p for p in self.params if not (sparse and p in TABLES)]
        self.mu = {p: torch.zeros_like(self.params[p]) for p in adam}
        self.nu = {p: torch.zeros_like(self.params[p]) for p in adam}
        self.acc = {p: torch.zeros(self.params[p].shape[0],
                                   device=self.params[p].device)
                    for p in TABLES} if sparse else {}
        self.count = 0
        self.first_grad: Dict[str, float] = {}

    def _loss_and_grads(self, batch):
        pos = batch["item_ids"]
        negs = negatives(self.gen, pos, self.cdf, self.m.negative_samples)
        items = torch.cat([pos.long()[:, None], negs], dim=1)
        if self.fault is not None:
            batch, items = self.fault(batch, items)
        names = [p for p in self.params
                 if not (self.sparse and p in TABLES)]
        leaves = {p: self.params[p].detach().requires_grad_(True)
                  for p in names}
        rows = None
        if self.sparse:
            rows = {"user_rows": self.params["user_emb"][
                        batch["user_ids"].long()].requires_grad_(True),
                    "item_rows": self.params["item_emb"][
                        items.long()].requires_grad_(True)}
        tree = _rebuild(self.tree, {**self.params, **leaves})
        with torch.enable_grad():
            loss = bce(self.forward(tree, batch, items, self.gen, self.dept,
                                    self.cat, rows))
            wrt = list(leaves.values()) + (list(rows.values()) if rows
                                           else [])
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(wrt, grads)]
        g = dict(zip(names, grads[:len(names)]))
        row_g = grads[len(names):]
        return float(loss), batch, items, g, row_g

    def _adam(self, p: str, g: torch.Tensor, lr: float) -> None:
        self.mu[p].mul_(B1).add_(g, alpha=1.0 - B1)
        self.nu[p].mul_(B2).addcmul_(g, g, value=1.0 - B2)
        c = self.count + 1
        upd = (self.mu[p] / (1.0 - B1 ** c)) / (
            (self.nu[p] / (1.0 - B2 ** c)).sqrt() + EPS)
        if self.table_fault == "frozen" and p in TABLES:
            return
        self.params[p].sub_(lr * upd)

    @torch.no_grad()
    def step(self, batch) -> float:
        loss, batch, items, g, row_g = self._loss_and_grads(batch)
        t = self.t
        clip, wd, lr = t.gradient_clip_norm, t.weight_decay, t.learning_rate
        if not self.sparse:
            norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            for p, x in g.items():
                x = x * scale + wd * self.params[p]
                if self.count == 0:
                    self.first_grad[p] = float(x.norm())
                self._adam(p, x, lr)
        else:
            ids = {"user_emb": batch["user_ids"].long(),
                   "item_emb": items.long().reshape(-1)}
            totals = {}
            for p, rg in zip(TABLES, row_g):
                u, inv = torch.unique(ids[p], return_inverse=True)
                tot = torch.zeros((u.numel(), rg.shape[-1]),
                                  device=rg.device)
                tot.index_add_(0, inv, rg.reshape(-1, rg.shape[-1]))
                totals[p] = (u, tot)
            sq = sum(x.square().sum() for x in g.values()) + sum(
                tot.square().sum() for _, tot in totals.values())
            scale = min(1.0, clip / math.sqrt(float(sq)))
            for p, x in g.items():
                x = x * scale + wd * self.params[p]
                if self.count == 0:
                    self.first_grad[p] = float(x.norm())
                self._adam(p, x, lr)
            e_lr = t.embedding_learning_rate or lr
            for p, (u, tot) in totals.items():
                table = self.params[p]
                tot = tot * scale + t.embedding_weight_decay * table[u]
                g2 = tot.square().mean(dim=1)
                self.acc[p][u] += g2
                if self.count == 0:
                    self.first_grad[p] = float(tot.norm())
                upd = e_lr * tot / (self.acc[p][u].sqrt()
                                    + t.embedding_adagrad_eps)[:, None]
                if self.table_fault == "shifted":
                    table[(u + 1) % table.shape[0]] -= upd
                elif self.table_fault != "frozen":
                    table[u] -= upd
        self.count += 1
        return loss


def _rebuild(tree, by_path: Dict[str, torch.Tensor], path: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, by_path, f"{path}/{i}")
                for i, v in enumerate(tree)]
    return by_path[path]


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float],
              only: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's ``|prog - want| / max(want, median of want)`` (``only``:
    those leaves)."""
    names = [p for p in want if only is None or p in only]
    med = sorted(want[p] for p in names)[len(names) // 2]
    return {p: abs(prog[p] - want[p]) / max(want[p], med, 1e-30)
            for p in names}


def worst_gap(prog, want, only=None) -> float:
    return max(leaf_gaps(prog, want, only).values())


def median_gap(prog, want, only=None) -> float:
    gaps = sorted(leaf_gaps(prog, want, only).values())
    return gaps[len(gaps) // 2]


def table_gap(prog, want, only) -> float:
    """The worse table's gap of the change (``only``: the leaves counted
    for the median)."""
    gaps = leaf_gaps(prog, want, only)
    return max(gaps[p] for p in TABLES)


def stray_gap(prog_rows, want_rows, want) -> float:
    """The worse table's norm of the program's change over the rows whose
    reference change is exactly nought, over the reference's norm of that
    table's change (``*_rows``: each table's squared change a row)."""
    return max(float(prog_rows[p][want_rows[p] == 0].double().sum())
               ** 0.5 / max(want[p], 1e-30) for p in TABLES)


def moving(first_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    vals = sorted(first_grad.values())
    med = vals[len(vals) // 2]
    return [p for p, v in first_grad.items() if v >= 1e-3 * med]
