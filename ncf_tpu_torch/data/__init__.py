from ncf_tpu_torch.data.interactions import SECONDS_PER_DAY, Interactions
from ncf_tpu_torch.data.pipeline import BatchIterator
from ncf_tpu_torch.data.sampler import (
    make_sampling_cdf,
    sample_negatives,
    sample_negatives_stratified,
)
from ncf_tpu_torch.data.synthetic import generate_interactions, temporal_features

__all__ = [
    "Interactions",
    "SECONDS_PER_DAY",
    "BatchIterator",
    "make_sampling_cdf",
    "sample_negatives",
    "sample_negatives_stratified",
    "generate_interactions",
    "temporal_features",
]
