from ncf_tpu_torch.serving.scorer import (AdvancedNCFScorer, BruteForceScorer,
                                          SequenceRescoreScorer)
from ncf_tpu_torch.serving.server import ModelServer

__all__ = ["AdvancedNCFScorer", "BruteForceScorer", "ModelServer",
           "SequenceRescoreScorer"]
