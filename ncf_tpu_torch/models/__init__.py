"""Model registry: name -> (init, apply, score_candidates, ...)."""

from types import SimpleNamespace

from ncf_tpu_torch.models import advanced_ncf, ncf
from ncf_tpu_torch.utils.config import ModelConfig

_NCF = SimpleNamespace(
    init=ncf.init, apply=ncf.apply, score_candidates=ncf.score_candidates,
    get_user_embeddings=ncf.get_user_embeddings,
    get_product_embeddings=ncf.get_product_embeddings)

_REGISTRY = {
    "ncf": _NCF,
    "neumf": _NCF,
    "advanced_ncf": SimpleNamespace(
        init=advanced_ncf.init,
        apply=advanced_ncf.apply,
        score_candidates=advanced_ncf.score_candidates,
        score_items_with_hour=advanced_ncf.score_items_with_hour,
        get_user_embeddings=advanced_ncf.get_user_embeddings,
        get_product_embeddings=advanced_ncf.get_product_embeddings,
    ),
}


def get_model(name: str):
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = ["get_model", "ModelConfig", "advanced_ncf", "ncf"]
