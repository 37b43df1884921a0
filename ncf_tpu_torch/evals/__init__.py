from ncf_tpu_torch.evals.evaluate import (
    DeviceEvaluator,
    EvalSet,
    evaluate,
    make_score_fn,
    metrics_from_ranks,
    sample_eval_users,
)
from ncf_tpu_torch.evals.full_eval import (
    FullCatalogEvaluator,
    full_ranks_naive,
)
from ncf_tpu_torch.evals.metrics import (
    accuracy_stats,
    auc,
    calculate_metrics,
    hit_rate_at_k,
    map_at_k,
    mrr_at_k,
    ndcg_at_k,
    positive_ranks,
    rank_metrics,
)

__all__ = [
    "DeviceEvaluator",
    "EvalSet",
    "FullCatalogEvaluator",
    "full_ranks_naive",
    "metrics_from_ranks",
    "sample_eval_users",
    "evaluate",
    "make_score_fn",
    "rank_metrics",
    "calculate_metrics",
    "positive_ranks",
    "hit_rate_at_k",
    "ndcg_at_k",
    "mrr_at_k",
    "map_at_k",
    "auc",
    "accuracy_stats",
]
