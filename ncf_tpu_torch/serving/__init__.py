from ncf_tpu_torch.serving.ann import ProductSearch
from ncf_tpu_torch.serving.cache import FeatureCache, TTLCache
from ncf_tpu_torch.serving.export import (
    export_interactions_jsonl,
    export_product_embeddings,
    export_user_embeddings,
    l2_normalize,
    load_embeddings_jsonl,
)
from ncf_tpu_torch.serving.features import FeatureProcessor, FeatureStore
from ncf_tpu_torch.serving.scorer import (AdvancedNCFScorer, BruteForceScorer,
                                          SequenceRescoreScorer)
from ncf_tpu_torch.serving.server import ModelServer

__all__ = [
    "ProductSearch",
    "FeatureCache",
    "TTLCache",
    "FeatureProcessor",
    "FeatureStore",
    "AdvancedNCFScorer",
    "BruteForceScorer",
    "SequenceRescoreScorer",
    "ModelServer",
    "export_product_embeddings",
    "export_user_embeddings",
    "export_interactions_jsonl",
    "load_embeddings_jsonl",
    "l2_normalize",
]
