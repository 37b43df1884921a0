from ncf_tpu_torch.evals.metrics import (
    accuracy_stats,
    positive_ranks,
    rank_metrics,
)

__all__ = ["accuracy_stats", "positive_ranks", "rank_metrics"]
