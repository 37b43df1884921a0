from ncf_tpu_torch.utils.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    ServingConfig,
    TrainConfig,
    setup_logging,
)
from ncf_tpu_torch.utils.device import resolve_device, torch_dtype

__all__ = [
    "Config",
    "DataConfig",
    "MeshConfig",
    "ModelConfig",
    "ServingConfig",
    "TrainConfig",
    "setup_logging",
    "resolve_device",
    "torch_dtype",
]
