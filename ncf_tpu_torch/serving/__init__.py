from ncf_tpu_torch.serving.scorer import (AdvancedNCFScorer,
                                          SequenceRescoreScorer)
from ncf_tpu_torch.serving.server import ModelServer

__all__ = ["AdvancedNCFScorer", "ModelServer", "SequenceRescoreScorer"]
