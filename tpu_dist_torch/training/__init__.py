"""Training layer: the fit engine, its callbacks and checkpoints."""

from tpu_dist_torch.training import checkpoint
from tpu_dist_torch.training.callbacks import (Callback, EarlyStopping,
                                               History, LambdaCallback,
                                               ModelCheckpoint, StopTraining)
from tpu_dist_torch.training.checkpoint import AsyncCheckpointer
from tpu_dist_torch.training.trainer import Trainer

__all__ = ["checkpoint", "AsyncCheckpointer", "Callback", "EarlyStopping",
           "History", "LambdaCallback", "ModelCheckpoint", "StopTraining",
           "Trainer"]
