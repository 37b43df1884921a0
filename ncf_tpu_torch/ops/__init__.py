from ncf_tpu_torch.ops.embedding import embedding_lookup
from ncf_tpu_torch.ops.topk import (
    PreparedItems,
    prepare_items,
    rescore_exact,
    topk_scores,
    topk_scores_dense,
    topk_scores_streaming,
    topk_scores_streaming_ref,
    topk_scores_xla,
)

__all__ = [
    "embedding_lookup",
    "PreparedItems",
    "prepare_items",
    "rescore_exact",
    "topk_scores",
    "topk_scores_dense",
    "topk_scores_streaming",
    "topk_scores_streaming_ref",
    "topk_scores_xla",
]
