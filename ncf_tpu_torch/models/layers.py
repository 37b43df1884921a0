"""Functional NN primitives: param-dict init fns + pure apply fns.

Port of ``ncf_tpu/models/layers.py``.  Parameters are plain nested dicts
of tensors with the JAX pytree's keys and its ``[in, out]`` weight layout,
so checkpoints load in both packages.

Casts are explicit, as in the JAX package: with ``dtype`` set, matmul
operands are rounded to it (bf16 by default from the model config) and
the product accumulates and returns in float32 — the ``dot_general(...,
preferred_element_type=f32)`` of the reference.  Rounding an operand to
bf16 and widening it back is exact, so a float32 matmul of the widened
operands is that product.  LayerNorm runs in float32.

Init functions draw from an explicit ``torch.Generator``; the numbers
differ from ``jax.random`` for the same seed, so parity tests load the
same weights into both packages instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

Params = Dict[str, Any]


def _device(gen: torch.Generator, device) -> torch.device:
    return torch.device(device) if device is not None else gen.device


def _uniform(gen, shape, bound, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=_device(gen, device))
    return u * (2.0 * bound) - bound


# ----------------------------------------------------------------- dense

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               device=None) -> Params:
    """Kaiming-uniform fan-in init (the torch.nn.Linear default)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (in_dim, out_dim), bound, device),
            "b": _uniform(gen, (out_dim,), bound, device)}


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w + b`` with operands rounded to ``dtype`` and a float32
    product (``layers.py:39-48``)."""
    w, b = p["w"], p["b"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y + b.to(torch.float32)


# ------------------------------------------------------------- layer norm

def layer_norm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 for numerical stability, cast back to input dtype."""
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(orig_dtype)


# --------------------------------------------------------------- dropout

def dropout_mask(rng: torch.Generator, shape, rate: float,
                 device=None) -> torch.Tensor:
    """Bernoulli keep mask (True with probability ``1 - rate``) drawn from
    ``rng`` on ``device`` (default: the generator's)."""
    if not isinstance(rng, torch.Generator):
        raise TypeError(f"dropout needs a torch.Generator, got {type(rng)}")
    dev = rng.device if device is None else device
    return torch.rand(shape, generator=rng, device=dev) < (1.0 - rate)


def dropout(rng: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (``layers.py:70-77``): kept elements scale by
    ``1 / (1 - rate)``, the dtype is kept.  The mask comes from ``rng``
    (a generator on ``x``'s device), so its bits are not ``jax.random``'s:
    parity with the reference holds in distribution."""
    if deterministic or rate <= 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(rng, x.shape, rate, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


# ------------------------------------------------------ multi-head attention

def mha_init(gen: torch.Generator, embed_dim: int, device=None) -> Params:
    """Q/K/V/out projection params."""
    return {name: dense_init(gen, embed_dim, embed_dim, device)
            for name in ("q", "k", "v", "o")}


# ------------------------------------------------------------- MLP tower

def mlp_tower_init(gen: torch.Generator, in_dim: int, hidden_dims: List[int],
                   device=None) -> List[Params]:
    """[Linear -> ReLU -> LayerNorm -> Dropout] per hidden dim."""
    layers = []
    cur = in_dim
    for h in hidden_dims:
        layers.append({"dense": dense_init(gen, cur, h, device),
                       "norm": layer_norm_init(h, _device(gen, device))})
        cur = h
    return layers


def mlp_tower(
    layers: List[Params],
    x: torch.Tensor,
    dropout_rate: float = 0.0,
    rng: Optional[Any] = None,
    deterministic: bool = True,
    dtype=None,
) -> torch.Tensor:
    """[Linear -> ReLU -> LayerNorm -> Dropout] per layer; each layer's
    mask is the next draw from ``rng`` (the reference folds the layer
    index into its key)."""
    for layer in layers:
        x = dense(layer["dense"], x, dtype)
        x = torch.relu(x)
        x = layer_norm(layer["norm"], x)
        x = dropout(rng, x, dropout_rate, deterministic)
    return x


# ------------------------------------------------------------- embeddings

def embedding_init(gen: torch.Generator, num: int, dim: int,
                   scale: float = 0.1, device=None) -> torch.Tensor:
    """N(0, scale) embedding table."""
    return torch.randn((num, dim), generator=gen,
                       device=_device(gen, device)) * scale
