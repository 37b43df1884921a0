"""A frozen copy of AdvancedNCF's equations in plain PyTorch, the
benchmark's reference.  It imports nothing of the port: the equations
follow ``models/advanced_ncf.py`` and ``models/layers.py`` as the port
states them, written out again.

Precision is explicit.  ``Prec`` says how each kind of product rounds
its operands, and every product then runs on f32 values with TF32 off,
so that a product is exact up to the order of its f32 sums:

- ``dot``: the f32 dot products of the MF path and retrieval (the
  configuration's ``param_dtype``); ``"f32"`` leaves them, ``"tf32"``
  rounds them to TF32's 10-bit mantissa;
- ``act``: the operands the configuration's ``compute_dtype`` rounds
  (``"bfloat16"``; ``"float8"`` is e4m3, the control's step below it).

``EXACT`` is the configuration's precision and ``CONTROL`` the nearest
below it: the control of every cell's comparison.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


@dataclass(frozen=True)
class Prec:
    dot: str = "f32"
    act: str = "bfloat16"


EXACT = Prec("f32", "bfloat16")
CONTROL = Prec("tf32", "float8")


class _Round(torch.autograd.Function):
    """Round to a lower precision and back to f32.  The gradient passes
    through in f32: the reference's gradient is that of the rounded
    forward, computed exactly."""

    @staticmethod
    def forward(ctx, x, kind):
        return _round(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if kind == "f32":
        return x
    if kind == "tf32":
        # round to nearest (ties away) on the 13 low mantissa bits
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return torch.where(torch.isfinite(x), bits.view(torch.float32), x)
    if kind == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "float8":
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(
            torch.float32)
    raise ValueError(f"unknown rounding {kind!r}")


def rnd(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f32":
        return x.to(torch.float32)
    return _Round.apply(x, kind)


def no_tf32() -> None:
    """Every f32 product of the reference runs in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
          kind: Optional[str] = None) -> torch.Tensor:
    """``x @ w + b``: with ``kind``, both operands rounded to it; the
    product and the bias in f32."""
    w = p["w"]
    if kind is not None:
        x, w = rnd(x, kind), rnd(w, kind)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)) \
        + p["b"].to(torch.float32)


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def singleton_attention(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Multi-head attention with one key and one value: Wo(Wv x + bv) +
    bo (the softmax over one key is 1)."""
    return dense(p["o"], dense(p["v"], x, kind), kind)


def hierarchy(p, dept_ids: torch.Tensor, cat_ids: torch.Tensor,
              prec: Prec, drop=None) -> torch.Tensor:
    """The category-hierarchy vector of each id pair:
    LN(dropout(Wo Wv dept_e) + cat_e)."""
    fused = singleton_attention(p["attn"], p["dept"][dept_ids.long()],
                                prec.act)
    if drop is not None:
        fused = drop(fused)
    return layer_norm(p["norm"], fused + p["cat"][cat_ids.long()])


def sinusoid(dim: int, device, max_period: int = 365) -> torch.Tensor:
    """pe[p, 2i] = sin(p w_i), pe[p, 2i+1] = cos(p w_i),
    w_i = exp(-2i ln(10000) / d)."""
    pos = torch.arange(max_period, dtype=torch.float32,
                       device=device)[:, None]
    half = (dim + 1) // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * 2.0 * (-math.log(10000.0) / dim))
    ang = pos * div[None, :]
    pe = torch.zeros((max_period, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)[:, :half]
    pe[:, 1::2] = torch.cos(ang)[:, :dim // 2]
    return pe


def temporal(p, hour, day, month, doy) -> torch.Tensor:
    """hour + weekday + month embeddings, then the seasonal sinusoid of
    the day of the year."""
    pe = sinusoid(p["hour"].shape[1], p["hour"].device)
    return (p["hour"][hour.long()] + p["day"][day.long()]
            + p["month"][month.long()]) + pe[doy.long() % 365]


def tower(layers: List[Dict], x: torch.Tensor, kind: str,
          drops=None) -> torch.Tensor:
    """[Linear -> ReLU -> LayerNorm -> Dropout] a layer; the operands of
    each Linear rounded to ``kind``; ``drops[i]`` applies layer i's
    dropout."""
    for i, layer in enumerate(layers):
        x = layer_norm(layer["norm"], torch.relu(dense(layer["dense"], x,
                                                       kind)))
        if drops is not None:
            x = drops[i](x)
    return x


# ------------------------------------------------------------- serving

def item_bias(params, m, ctx: Dict[str, int], item_dept, item_cat,
              prec: Prec, chunk: int = 1 << 20) -> torch.Tensor:
    """The eval-mode logit's item term under one temporal context, f32
    [I]: wf1 b_mf + wf2 mlp_pred(i, t) + b_final, where mlp_pred runs the
    item's MLP vector (with its hierarchy vector) through the singleton
    attention, joins the context's temporal vector and takes the tower
    and the MLP head."""
    dev = params["item_emb"].device
    dmf = m.mf_dim
    t_ids = {k: torch.full((1,), int(ctx.get(k, 0)), dtype=torch.long,
                           device=dev)
             for k in ("hour", "day", "month", "day_of_year")}
    t_vec = temporal(params["temporal"], t_ids["hour"], t_ids["day"],
                     t_ids["month"], t_ids["day_of_year"])[0]
    wf, bf = params["final"]["w"][:, 0], params["final"]["b"][0]
    out = []
    for lo in range(0, m.num_items, chunk):
        hi = min(lo + chunk, m.num_items)
        x = layer_norm(params["mlp_norm"], params["item_emb"][lo:hi, dmf:])
        if getattr(m, "use_category", True):
            x = x + hierarchy(params["category"], item_dept[lo:hi],
                              item_cat[lo:hi], prec)
        attn = singleton_attention(params["attn"], x, prec.act)
        comb = torch.cat([attn, t_vec[None, :].expand(hi - lo, -1)], dim=1)
        h = tower(params["mlp"], comb, prec.act)
        mlp_pred = dense(params["mlp_out"], h)[:, 0]
        out.append(wf[0] * params["mf_out"]["b"][0] + wf[1] * mlp_pred + bf)
    return torch.cat(out)


def item_vectors(params, m) -> torch.Tensor:
    """LN(i_mf): the item side of the MF dot product, f32 [I, dmf]."""
    return layer_norm(params["mf_norm"], params["item_emb"][:, :m.mf_dim])


def user_queries(params, m, users: torch.Tensor) -> torch.Tensor:
    """wf1 LN(u_mf) o w_mf: the user side, f32 [B, dmf], so that the
    logit is q_u . v_i + bias_i."""
    u = layer_norm(params["mf_norm"],
                   params["user_emb"][users.long(), :m.mf_dim])
    return u * params["mf_out"]["w"][:, 0] * params["final"]["w"][0, 0]


def scores(q: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
           prec: Prec) -> torch.Tensor:
    """f32 [B, I] logits q . v + bias, the dot in ``prec.dot``."""
    return torch.matmul(rnd(q, prec.dot), rnd(v, prec.dot).T) + bias
