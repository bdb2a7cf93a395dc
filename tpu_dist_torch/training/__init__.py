"""Training layer: the fit engine and its callbacks."""

from tpu_dist_torch.training.callbacks import Callback, History, StopTraining
from tpu_dist_torch.training.trainer import Trainer

__all__ = ["Callback", "History", "StopTraining", "Trainer"]
