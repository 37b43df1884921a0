from ncf_tpu_torch.ops.embedding import embedding_lookup
from ncf_tpu_torch.ops.topk import (
    PreparedItems,
    PreparedItemsInt8,
    prepare_items,
    prepare_items_int8,
    rescore_exact,
    topk_scores,
    topk_scores_dense,
    topk_scores_pallas,
    topk_scores_segmented,
    topk_scores_streaming,
    topk_scores_streaming_int8,
    topk_scores_streaming_ref,
    topk_scores_xla,
)

__all__ = [
    "embedding_lookup",
    "PreparedItems",
    "PreparedItemsInt8",
    "prepare_items",
    "prepare_items_int8",
    "rescore_exact",
    "topk_scores",
    "topk_scores_dense",
    "topk_scores_pallas",
    "topk_scores_segmented",
    "topk_scores_streaming",
    "topk_scores_streaming_int8",
    "topk_scores_streaming_ref",
    "topk_scores_xla",
]
