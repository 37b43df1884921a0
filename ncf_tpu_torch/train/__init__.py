from ncf_tpu_torch.train import checkpoint

__all__ = ["checkpoint"]
