from ncf_tpu_torch.ops.embedding import embedding_lookup, get_impl, set_impl
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



def launch_counters():
    """Every counter the program keeps, by name: each kernel wrapper's
    launches (by kernel name), B4b's by the schedule it took
    (``fused_tower_bwd.rows64``: tiles of 64 rows; ``rows32``,
    ``rows16``), and the sparse update's rows a combine touches and
    processes (counted while a profiler records)."""
    from ncf_tpu_torch.ops import (gather, sampler, scatter, temporal_sum,
                                   topk, tower)
    from ncf_tpu_torch.train.sparse import combine_duplicate_rows

    return {"topk_scores_streaming": topk.topk_scores_streaming.launches,
            "fused_tower_fwd": tower.fused_tower.fwd_launches,
            "fused_tower_bwd": tower.fused_tower.bwd_launches,
            "tree_sample_negatives": sampler.tree_sample_negatives.launches,
            "onehot_scatter_add": scatter.onehot_scatter_add.launches,
            "fused_lookup_sum": temporal_sum.fused_lookup_sum.launches,
            "topk_scores_streaming_int8":
                topk.topk_scores_streaming_int8.launches,
            "gather_rows": gather.gather_rows.launches,
            "topk_scores_pallas": topk.topk_scores_pallas.launches,
            "topk_scores_segmented": topk.topk_scores_segmented.launches,
            "sparse_rows_touched": combine_duplicate_rows.rows_touched,
            "sparse_rows_processed": combine_duplicate_rows.rows_processed,
            **{f"fused_tower_bwd.{k}": c
               for k, c in tower.fused_tower.bwd_schedules.items()}}


__all__ = [
    "launch_counters",
    "embedding_lookup",
    "get_impl",
    "set_impl",
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
