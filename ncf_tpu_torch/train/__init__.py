from ncf_tpu_torch.train import checkpoint
from ncf_tpu_torch.train.optim import make_optimizer, make_schedule
from ncf_tpu_torch.train.step import (bce_loss, bpr_loss, make_eval_step,
                                      make_multi_train_step, make_train_step)
from ncf_tpu_torch.train.trainer import Trainer

__all__ = [
    "Trainer",
    "checkpoint",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "make_multi_train_step",
    "make_eval_step",
    "bce_loss",
    "bpr_loss",
]
