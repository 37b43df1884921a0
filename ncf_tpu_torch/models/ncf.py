"""Vanilla NCF / NeuMF — port of ``ncf_tpu/models/ncf.py``.

GMF (+) MLP fusion in the He et al. 2017 NeuMF shape, with AdvancedNCF's
batch contract (``user_ids [B]``, ``item_ids [B, S]`` -> logits [B, S]).
Every lookup goes through ``ops.embedding.embedding_lookup``, so
``set_impl("pallas")`` routes them to the gather kernel B7.  The tower is
the plain ``mlp_tower`` (the reference does not fuse it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ncf_tpu_torch.models.layers import (
    dense,
    dense_init,
    embedding_init,
    mlp_tower,
    mlp_tower_init,
)
from ncf_tpu_torch.ops.embedding import embedding_lookup
from ncf_tpu_torch.utils.config import ModelConfig
from ncf_tpu_torch.utils.device import torch_dtype

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Build the parameter dict with the reference's keys and shapes;
    tensors live on ``device`` (default: the generator's device).
    ``device="meta"`` gives a shape-only template."""
    dev = torch.device(device) if device is not None else gen.device
    return {
        "gmf_user": embedding_init(gen, cfg.num_users, cfg.mf_dim, 0.01, dev),
        "gmf_item": embedding_init(gen, cfg.num_items, cfg.mf_dim, 0.01, dev),
        "mlp_user": embedding_init(gen, cfg.num_users, cfg.mlp_dim, 0.01, dev),
        "mlp_item": embedding_init(gen, cfg.num_items, cfg.mlp_dim, 0.01, dev),
        "mlp": mlp_tower_init(gen, 2 * cfg.mlp_dim, list(cfg.mlp_hidden_dims),
                              dev),
        # NeuMF head over [gmf_vector ; mlp_tower_out]
        "out": dense_init(gen, cfg.mf_dim + cfg.mlp_hidden_dims[-1], 1, dev),
    }


def apply(
    params: Params,
    cfg: ModelConfig,
    user_ids: torch.Tensor,   # [B]
    item_ids: torch.Tensor,   # [B, S]
    temporal: Optional[Dict[str, torch.Tensor]] = None,  # unused; API parity
    item_dept: Optional[torch.Tensor] = None,
    item_cat: Optional[torch.Tensor] = None,
    candidate_attention: bool = True,  # unused; API parity
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    history: Optional[torch.Tensor] = None,  # unused; API parity
) -> torch.Tensor:
    """Logits [B, S].  Training-mode dropout masks come from ``rng``."""
    del temporal, item_dept, item_cat, candidate_attention, history
    dtype = torch_dtype(cfg.compute_dtype)
    B, S = item_ids.shape

    u_gmf = embedding_lookup(params["gmf_user"], user_ids)[:, None, :]
    i_gmf = embedding_lookup(params["gmf_item"], item_ids)
    gmf_vec = u_gmf * i_gmf                                    # [B, S, dmf]

    u_mlp = embedding_lookup(params["mlp_user"], user_ids)[:, None, :].expand(
        B, S, cfg.mlp_dim)
    i_mlp = embedding_lookup(params["mlp_item"], item_ids)
    mlp_in = torch.cat([u_mlp, i_mlp], dim=-1).to(dtype)
    mlp_vec = mlp_tower(params["mlp"], mlp_in, cfg.dropout, rng,
                        deterministic, dtype)

    fused = torch.cat([gmf_vec.to(torch.float32),
                       mlp_vec.to(torch.float32)], dim=-1)
    return dense(params["out"], fused)[..., 0]


def get_user_embeddings(params: Params, user_ids: torch.Tensor):
    """The GMF half as the 'mf' vector, the MLP half as 'mlp'."""
    return {"mf": embedding_lookup(params["gmf_user"], user_ids),
            "mlp": embedding_lookup(params["mlp_user"], user_ids)}


def get_product_embeddings(params: Params, cfg: ModelConfig,
                           item_ids: torch.Tensor, item_dept=None,
                           item_cat=None):
    return {"mf": embedding_lookup(params["gmf_item"], item_ids),
            "mlp": embedding_lookup(params["mlp_item"], item_ids)}


def score_candidates(
    params: Params,
    cfg: ModelConfig,
    user_ids: torch.Tensor,
    cand_items: torch.Tensor,
    temporal: Optional[Dict[str, torch.Tensor]] = None,
    item_dept: Optional[torch.Tensor] = None,
    item_cat: Optional[torch.Tensor] = None,
    history: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return apply(params, cfg, user_ids, cand_items, temporal,
                 item_dept, item_cat, deterministic=True)
