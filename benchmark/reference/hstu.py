"""A frozen copy of HSTU's equations in plain PyTorch, and its training
steps: the reference of the ``train_hstu`` cells.  It imports nothing of
the port and no kernel; the equations follow Zhai et al., ICML 2024
(arXiv:2402.17152) as ``models/hstu.py`` states them, written out again.

    X = dropout(sqrt(d) E[i_p] + P[p])
    per block:  [U | V | Q | K] = SiLU(LN(X) W_uvqk)
                A_h[i, j] = SiLU(Q_h[i] . K_h[j] + rab[i, j]) / N, j <= i
                rab[i, j] = w_pos[N - 1 + j - i] + w_ts[b(t_{i+1} - t_j)]
                b(x) = clamp(floor(ln(max(|x|, 1)) / 0.301), 0, 128)
                X = X + W_o dropout(U * LN(concat_h A_h V_h)) + b_o
    u_p = X_p / max(|X_p|, 1e-6); the target of p is i_{p+1}; the logits
    are <u_p, e / max(|e|, 1e-6)> / temperature over the target and the
    step's negatives, a negative equal to the target masked out; the
    loss is the mean cross-entropy over every target of the batch.

Departures from the published code, each stated by the configuration:
t_L := t_{L-1} for every sequence (the public code takes it for a
sequence that fills N); a negative equal to its target is masked; the
item table takes rowwise Adagrad (decay on touch) and the rest Adam with
L2 decay in the gradient, clipped together at 5.0; products in bf16.

Precision as ``model.py``'s ``Prec`` states: every product runs in f32
with TF32 off, on operands rounded to ``act`` (bf16; the control's fp8
e4m3): W_uvqk and its input, Q and K, A and V, W_o and its input; the
logits' dot products are rounded to ``dot`` (f32; the control's TF32).
The gradient is autograd's, exact, of that rounded forward.

It runs one sequence at a time (no batching across sequences, so a
history of 8,192 fits), accumulating the gradients; the draws are the
program's: the negatives [P, negatives] uniform, the input's dropout
mask [T, d], then each block's [T, H d_v], from the step's generator, in
that order, for the whole batch.  ``fault`` plants a fault for the
calibration: ``"no_rab"`` (block 0's bias left out), ``"softmax"`` (a
softmax over j <= i in SiLU/N's place), ``"mask_shift"`` (the causal mask
one position off: j <= i + 1), ``"half_batch"`` (the loss over the first
half of the sequences); ``table_fault="frozen"`` leaves the table's rows
unmoved while its accumulator moves, ``"shifted"`` writes each touched
row's update to the next row.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import model as ref
from benchmark.reference.train import B1, B2, EPS, _rebuild

TABLE = "item_emb"
BUCKETS = 129
BIAS = ("w_pos", "w_ts")
FAULTS = (None, "no_rab", "softmax", "mask_shift", "half_batch")


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-6)


def bucket(dt: torch.Tensor) -> torch.Tensor:
    x = dt.abs().clamp(min=1).to(torch.float32)
    return torch.floor(torch.log(x) / 0.301).clamp(0, BUCKETS - 1).long()


class _Take(torch.autograd.Function):
    """``table[idx]``, whose backward sums the gradient by index with
    ``bincount`` (one pass; in an order that may change from run to run,
    which a reference may: it is compared by norms, not by bits)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return torch.bincount(idx.reshape(-1), weights=g.reshape(-1),
                              minlength=ctx.n).to(g.dtype), None


def bias_index(ts: torch.Tensor, N: int):
    """(w_pos's index N - 1 + j - i, w_ts's bucket of t_{i+1} - t_j) [L, L]
    of one sequence, t_L := t_{L-1}."""
    L = ts.shape[0]
    i = torch.arange(L, device=ts.device)
    nxt = ts[torch.clamp(i + 1, max=L - 1)]
    return N - 1 + i[None, :] - i[:, None], bucket(nxt[:, None] - ts[None, :])


def bias(w_pos, w_ts, ts: torch.Tensor, N: int, index=None) -> torch.Tensor:
    """rab [L, L] of one sequence (``index``: its ``bias_index``)."""
    pos, b = index if index is not None else bias_index(ts, N)
    return _Take.apply(w_pos, pos) + _Take.apply(w_ts, b)


def attention(q, k, v, rab, N: int, act: str, fault=None) -> torch.Tensor:
    """One sequence's heads: q, k, v [L, H, D] -> [L, H * D]."""
    L = q.shape[0]
    s = torch.einsum("ihd,jhd->hij", ref.rnd(q, act), ref.rnd(k, act))
    z = s if rab is None else s + rab
    i = torch.arange(L, device=q.device)
    allowed = i[None, :] <= i[:, None] + (1 if fault == "mask_shift" else 0)
    if fault == "softmax":
        a = torch.softmax(z.masked_fill(~allowed, float("-inf")), dim=-1)
    else:
        a = torch.where(allowed, silu(z) / N, torch.zeros_like(z))
    o = torch.einsum("hij,jhd->ihd", ref.rnd(a, act), ref.rnd(v, act))
    return o.reshape(L, -1)


def encode(P, m, e, ts, masks, act: str, fault=None) -> torch.Tensor:
    """X [L, d] of one sequence: ``e`` its item rows [L, d], ``ts`` its
    timestamps, ``masks`` its dropout masks (input, then each block's;
    None: no dropout)."""
    d, H, N = m.item_embedding_dim, m.num_heads, m.max_sequence_length
    dqk, dv = m.attention_dim, m.linear_dim
    keep = 1.0 - m.dropout
    L = e.shape[0]

    def drop(x, i):
        if masks is None:
            return x
        return torch.where(masks[i], x / keep, torch.zeros_like(x))

    x = drop(e * math.sqrt(d) + P["pos_emb"][:L], 0)
    index = bias_index(ts, N)
    for b, blk in enumerate(P["blocks"]):
        h = ref.rnd(layer_norm(x), act) @ ref.rnd(blk["uvqk"], act)
        u, v, q, k = torch.split(silu(h), [H * dv, H * dv, H * dqk, H * dqk],
                                 dim=1)
        rab = None if (fault == "no_rab" and b == 0) else \
            bias(blk["w_pos"], blk["w_ts"], ts, N, index)
        o = attention(q.reshape(L, H, dqk), k.reshape(L, H, dqk),
                      v.reshape(L, H, dv), rab, N, act, fault)
        y = drop(u * layer_norm(o), b + 1)
        x = x + ref.rnd(y, act) @ ref.rnd(blk["o"]["w"], act) + blk["o"]["b"]
    return x


class Reference:
    """The reference's training run of the jagged ``batches``:
    ``step(batch)`` takes one step and returns its loss; ``first_grad``
    holds each leaf's first gradient as the optimizer got it (the item
    table: its touched rows' totals), by its norm, and ``first_bias`` the
    relative bias tables' whole."""

    def __init__(self, m, t, params, gen: torch.Generator,
                 prec: ref.Prec = ref.EXACT, fault: Optional[str] = None,
                 table_fault: Optional[str] = None):
        if fault not in FAULTS or table_fault not in (None, "frozen",
                                                      "shifted"):
            raise ValueError(f"unknown fault {fault!r}, {table_fault!r}")
        ref.no_tf32()
        self.m, self.t, self.gen, self.prec = m, t, gen, prec
        self.fault, self.table_fault = fault, table_fault
        self.params = dict(weights.leaves(params))
        self.tree = params
        dense = [p for p in self.params if p != TABLE]
        self.mu = {p: torch.zeros_like(self.params[p]) for p in dense}
        self.nu = {p: torch.zeros_like(self.params[p]) for p in dense}
        table = self.params[TABLE]
        self.acc = torch.zeros(table.shape[0], device=table.device)
        self.gtab = torch.zeros_like(table)
        self.count = 0
        self.first_grad: Dict[str, float] = {}
        self.first_bias: Dict[str, torch.Tensor] = {}

    def _draws(self, T: int, P: int):
        m = self.m
        dev = self.params[TABLE].device
        negs = torch.randint(0, m.num_items, (P, m.negative_samples),
                             generator=self.gen, device=dev)
        keep = 1.0 - m.dropout
        if m.dropout <= 0.0:              # the program draws no mask
            return negs, None
        masks = [torch.rand((T, m.item_embedding_dim), generator=self.gen,
                            device=dev) < keep]
        for _ in range(m.num_blocks):
            masks.append(torch.rand((T, m.num_heads * m.linear_dim),
                                    generator=self.gen, device=dev) < keep)
        return negs, masks

    def _sequence(self, P, items, ts, negs, masks, scale):
        """One sequence's loss times ``scale``, its gradients accumulated
        (the table's into ``gtab``); returns its unscaled loss sum."""
        m = self.m
        d = m.item_embedding_dim
        L = items.shape[0]
        ids = torch.cat([items, negs.reshape(-1)])
        rows = self.params[TABLE][ids].detach().requires_grad_(True)
        with torch.enable_grad():
            e = rows[:L]
            x = encode(P, m, e, ts, masks, self.prec.act, self.fault)
            user = ref.rnd(unit(x[:L - 1]), self.prec.dot)
            tgt = items[1:]
            pos = (user * ref.rnd(unit(e[1:]), self.prec.dot)).sum(-1)
            neg_e = ref.rnd(unit(rows[L:].reshape(L - 1, negs.shape[1], d)),
                            self.prec.dot)
            neg = torch.einsum("pd,pkd->pk", user, neg_e)
            neg = neg.masked_fill(negs == tgt[:, None], float("-inf"))
            logits = torch.cat([pos[:, None], neg], 1) / m.temperature
            ce = torch.logsumexp(logits, 1) - logits[:, 0]
            (ce.sum() * scale).backward()
        self.gtab.index_add_(0, ids, rows.grad)
        return float(ce.detach().double().sum()), ids

    @torch.no_grad()
    def loss_and_grads(self, batch):
        """(loss, each dense leaf's gradient, the touched rows, their
        gradients' totals) of ``batch``, before the clip."""
        off = np.asarray(batch["offsets"], dtype=np.int64)
        T, S = int(off[-1]), off.size - 1
        negs, masks = self._draws(T, T - S)
        names = [p for p in self.params if p != TABLE]
        leaves = {p: self.params[p].detach().requires_grad_(True)
                  for p in names}
        P = _rebuild(self.tree, {**self.params, **leaves})
        use = S // 2 if self.fault == "half_batch" else S
        n_targets = int(off[use] - use)
        total, touched = 0.0, []
        for s in range(use):
            a, b = int(off[s]), int(off[s + 1])
            lo, hi = a - s, b - s - 1                  # its targets' rows
            sl = slice(a, b)
            loss, ids = self._sequence(
                P, batch["item_ids"][sl], batch["timestamps"][sl],
                negs[lo:hi], masks and [mk[sl] for mk in masks],
                1.0 / n_targets)
            total += loss
            touched.append(ids)
        g = {p: (leaves[p].grad if leaves[p].grad is not None
                 else torch.zeros_like(leaves[p])) for p in names}
        u = torch.unique(torch.cat(touched))
        tot = self.gtab[u]
        self.gtab[u] = 0.0
        return total / n_targets, g, u, tot

    @torch.no_grad()
    def step(self, batch) -> float:
        t = self.t
        loss, g, u, tot = self.loss_and_grads(batch)
        sq = sum(x.square().sum() for x in g.values()) + tot.square().sum()
        scale = min(1.0, t.gradient_clip_norm / math.sqrt(float(sq)))
        lr = t.learning_rate
        for p, x in g.items():
            x = x * scale + t.weight_decay * self.params[p]
            if self.count == 0:
                self.first_grad[p] = float(x.norm())
                if p.endswith(BIAS):
                    self.first_bias[p] = x.float().cpu()
            self._adam(p, x, lr)
        table = self.params[TABLE]
        tot = tot * scale + t.embedding_weight_decay * table[u]
        self.acc[u] += tot.square().mean(dim=1)
        if self.count == 0:
            self.first_grad[TABLE] = float(tot.norm())
        upd = (t.embedding_learning_rate or lr) * tot / (
            self.acc[u].sqrt() + t.embedding_adagrad_eps)[:, None]
        if self.table_fault == "shifted":
            table[(u + 1) % table.shape[0]] -= upd
        elif self.table_fault != "frozen":
            table[u] -= upd
        self.count += 1
        return loss

    def _adam(self, p: str, g: torch.Tensor, lr: float) -> None:
        self.mu[p].mul_(B1).add_(g, alpha=1.0 - B1)
        self.nu[p].mul_(B2).addcmul_(g, g, value=1.0 - B2)
        c = self.count + 1
        upd = (self.mu[p] / (1.0 - B1 ** c)) / (
            (self.nu[p] / (1.0 - B2 ** c)).sqrt() + EPS)
        self.params[p].sub_(lr * upd)
