from ncf_tpu_torch.train import checkpoint
from ncf_tpu_torch.train.optim import make_optimizer, make_schedule
from ncf_tpu_torch.train.step import (bce_loss, bpr_loss,
                                      init_sparse_opt_state, make_eval_step,
                                      make_multi_train_step,
                                      make_sparse_multi_train_step,
                                      make_sparse_train_step,
                                      make_train_step, sparse_mode_available)
from ncf_tpu_torch.train.trainer import Trainer

__all__ = [
    "Trainer",
    "checkpoint",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "make_multi_train_step",
    "make_sparse_train_step",
    "make_sparse_multi_train_step",
    "init_sparse_opt_state",
    "sparse_mode_available",
    "make_eval_step",
    "bce_loss",
    "bpr_loss",
]
