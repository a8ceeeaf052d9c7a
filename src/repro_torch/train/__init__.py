"""Optimizers, metrics and the training loop."""
from repro_torch.train.metrics import auc, binary_accuracy, logloss
from repro_torch.train.optimizer import (adam, apply_updates,
                                         chain_weight_decay,
                                         clip_by_global_norm, sgd)

__all__ = ["adam", "sgd", "clip_by_global_norm", "chain_weight_decay", "auc",
           "logloss", "apply_updates", "binary_accuracy"]
