"""Model registry: name -> (init, apply, score_candidates, ...).

Only ``advanced_ncf`` is ported so far; NCF/NeuMF come with a later
slice."""

from types import SimpleNamespace

from ncf_tpu_torch.models import advanced_ncf
from ncf_tpu_torch.utils.config import ModelConfig

_REGISTRY = {
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
    if name in ("ncf", "neumf"):
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = ["get_model", "ModelConfig", "advanced_ncf"]
