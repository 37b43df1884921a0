"""HSTU, the encoder of Generative Recommenders (Zhai et al., "Actions
Speak Louder than Words", ICML 2024, arXiv:2402.17152), trained on
jagged histories with a sampled softmax.

A sequence of items i_0..i_{L-1} with timestamps t_0 <= ... <= t_{L-1}
(seconds) is encoded as

    X = dropout(sqrt(d) E[i_p] + P[p])
    per block:  Xh = LN(X)                       (no affine, eps 1e-6)
                [U | V | Q | K] = SiLU(Xh W_uvqk)  (no bias)
                O = jagged causal attention (``ops/hstu_attention.py``)
                X = X + W_o dropout(U * LN(O)) + b_o
    u_p = X_p / |X_p|

and position p's target is i_{p+1}: the logits are <u_p, e> / temperature
over the target and ``negative_samples`` items drawn uniformly over the
catalogue (a negative equal to the target is masked), e the L2-normalised
item row, and the loss is the mean cross-entropy over every target
position of the batch.  There is no user table: a user is their history.
The products' operands are rounded to ``compute_dtype`` with f32
accumulation (``models/layers.py``'s convention); the logits' dot
products are f32.

Parameters: ``item_emb`` [V, d] (the one table: the sparse step updates
its touched rows), ``pos_emb`` [N, d], and per block ``uvqk`` [d,
2 H d_v + 2 H d_qk], ``o`` {w [H d_v, d], b [d]}, ``w_pos`` [2N - 1] and
``w_ts`` [129] (the relative bias, shared by the block's heads).

A batch is jagged: ``item_ids`` and ``timestamps`` int64 [T], the
sequences packed end to end, and ``offsets`` int64 [S + 1] on the host
(the launch plan is made from it without waiting for the card).  The
step draws from its generator in order: the negatives, the input's
dropout mask, then each block's.  While a profiler records, the forward
is spanned: ``hstu.batch`` (the batch to the card and its plan),
``hstu.embed``, ``hstu.uvqk``, ``hstu.attention``, ``hstu.out`` and
``hstu.loss`` (the negatives' logits, normalisation and the
cross-entropy; the negatives' draw and gather are in ``step.inputs``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ncf_tpu_torch.models.layers import dropout_mask
from ncf_tpu_torch.ops.hstu_attention import (BUCKETS, Plan, hstu_attention,
                                              host_to_device)
from ncf_tpu_torch.utils.profiling import annotate

TABLE_KEYS = ("item_emb",)
LN_EPS = 1e-6
NORM_EPS = 1e-6
_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def widths(m):
    """(d, blocks, heads, d_qk, d_v, N) of model config ``m``."""
    return (m.item_embedding_dim, m.num_blocks, m.num_heads, m.attention_dim,
            m.linear_dim, m.max_sequence_length)


def init(gen: torch.Generator, m, device=None) -> Dict[str, Any]:
    """The public code's initialisers: tables and the relative bias
    normal (items std 0.02, positions sqrt(1/d), bias 0.02), W_uvqk
    Xavier-uniform, W_o and b_o torch.nn.Linear's."""
    d, nb, H, dqk, dv, N = widths(m)
    dev = torch.device(device) if device is not None else gen.device

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, device=dev)
        return u * (2.0 * bound) - bound

    width = 2 * H * (dv + dqk)
    blocks = []
    for _ in range(nb):
        blocks.append({
            "uvqk": uniform((d, width), math.sqrt(6.0 / (d + width))),
            "o": {"w": uniform((H * dv, d), 1.0 / math.sqrt(H * dv)),
                  "b": uniform((d,), 1.0 / math.sqrt(H * dv))},
            "w_pos": normal((2 * N - 1,), 0.02),
            "w_ts": normal((BUCKETS,), 0.02)})
    return {"item_emb": normal((m.num_items, d), 0.02),
            "pos_emb": normal((N, d), math.sqrt(1.0 / d)),
            "blocks": blocks}


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


def _mm(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=NORM_EPS)


def _dropout(x, gen, rate, training):
    if not training or rate <= 0.0:
        return x
    keep = dropout_mask(gen, x.shape, rate, device=x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def positions(offsets: np.ndarray) -> np.ndarray:
    """Each packed position's index within its sequence."""
    lens = np.diff(offsets)
    return np.arange(offsets[-1]) - np.repeat(offsets[:-1], lens)


def encode(params, m, batch, gen, training: bool, rows=None):
    """The last block's output X [T, d] of the jagged ``batch`` (with its
    ``plan`` and ``pos``, from ``batch_to``); ``rows`` [T, d] stands in
    for the table's rows of ``item_ids``."""
    d, nb, H, dqk, dv, N = widths(m)
    dtype = _DTYPES[m.compute_dtype]
    plan, ts = batch["plan"], batch["timestamps"]
    T = plan.num_positions
    with annotate("hstu.embed"):
        e = rows if rows is not None else params["item_emb"][
            batch["item_ids"]]
        x = e * math.sqrt(d) + params["pos_emb"][batch["pos"]]
        x = _dropout(x, gen, m.dropout, training)
    for blk in params["blocks"]:
        with annotate("hstu.uvqk"):
            uvqk = F.silu(_mm(_ln(x), blk["uvqk"], dtype))
            u, v, q, k = torch.split(uvqk, [H * dv, H * dv, H * dqk,
                                            H * dqk], dim=1)
        with annotate("hstu.attention"):
            o = hstu_attention(q.reshape(T, H, dqk), k.reshape(T, H, dqk),
                               v.reshape(T, H, dv), blk["w_pos"],
                               blk["w_ts"], ts, plan, N)
        with annotate("hstu.out"):
            y = _dropout(u * _ln(o.reshape(T, H * dv)), gen, m.dropout,
                         training)
            x = x + _mm(y, blk["o"]["w"], dtype) + blk["o"]["b"]
    return x


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The jagged batch on ``device``: ids and timestamps moved, the
    offsets kept on the host, the launch plan and each position's index
    made from them."""
    with annotate("hstu.batch"):
        off = batch["offsets"]
        off = (off.numpy() if isinstance(off, torch.Tensor)
               else np.asarray(off)).astype(np.int64)
        dev = torch.device(device)
        out = {k: torch.as_tensor(batch[k]).to(dev, torch.int64,
                                               non_blocking=True)
               for k in ("item_ids", "timestamps")}
        out["pos"] = host_to_device(positions(off), dev)
        out["offsets"] = off
        out["plan"] = Plan(off, dev)
        return out


def targets(offsets: np.ndarray):
    """(source, target) int64 positions: every position but each
    sequence's last, and the one after it."""
    last = np.zeros(offsets[-1], dtype=bool)
    last[offsets[1:] - 1] = True
    src = np.flatnonzero(~last)
    return src, src + 1


def make_loss_fn(model, cfg, training: bool = True):
    """The step's loss (``train/step.py``'s contract): ``inputs`` draws
    the negatives [P, negative_samples] uniformly over the catalogue;
    ``rows(tables, batch, drawn, gather)`` gathers the item rows of the
    packed positions and of the negatives in one call and names the
    table they stand in for; ``loss_fn`` returns (loss, logits [P, 1 +
    negatives], targets)."""
    m = cfg.model

    def inputs(batch, gen, consts, negatives=None):
        off = batch["offsets"]
        src, tgt = targets(off)
        dev = batch["item_ids"].device
        P = src.size
        if negatives is None:
            negs = torch.randint(0, m.num_items, (P, m.negative_samples),
                                 generator=gen, device=dev)
        else:
            negs = torch.as_tensor(negatives).to(dev, torch.int64)
        return negs, host_to_device(src, dev), host_to_device(tgt, dev)

    def rows(tables, batch, drawn, gather):
        negs = drawn[0]
        ids = torch.cat([batch["item_ids"], negs.reshape(-1)])
        return {"item_rows": gather(tables["item_emb"], ids)}, [
            ("item_emb", ids)]

    def loss_fn(params, batch, gen, consts, negatives=None, drawn=None,
                item_rows=None, mesh=None):
        negs, src, tgt = drawn or inputs(batch, gen, consts, negatives)
        T = batch["item_ids"].shape[0]
        table = params.get("item_emb")
        if item_rows is None:
            seq_rows = table[batch["item_ids"]]
            neg_rows = table[negs]
        else:
            seq_rows = item_rows[:T]
            neg_rows = item_rows[T:].reshape(negs.shape + (-1,))
        x = encode(params, m, batch, gen, training, rows=seq_rows)
        with annotate("hstu.loss"):
            user = _normalize(x[src])
            pos = (user * _normalize(seq_rows[tgt])).sum(-1, keepdim=True)
            neg = torch.bmm(_normalize(neg_rows),
                            user[:, :, None])[..., 0]
            neg = neg.masked_fill(negs == batch["item_ids"][tgt][:, None],
                                  float("-inf"))
            logits = torch.cat([pos, neg], dim=1) / m.temperature
            loss = (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()
            t = torch.zeros_like(logits)
            t[:, 0] = 1.0
        return loss, logits, t

    loss_fn.inputs = inputs
    loss_fn.rows = rows
    return loss_fn
