"""Training layer: the fit engine, its callbacks and checkpoints."""

from tpu_dist_torch.training import checkpoint
from tpu_dist_torch.training.callbacks import (Callback, EarlyStopping,
                                               History, JSONLogger,
                                               LambdaCallback, LazyLogs,
                                               ModelCheckpoint, StopTraining,
                                               TensorBoard)
from tpu_dist_torch.training.checkpoint import AsyncCheckpointer
from tpu_dist_torch.training.trainer import Trainer

__all__ = ["checkpoint", "AsyncCheckpointer", "Callback", "EarlyStopping",
           "History", "JSONLogger", "LambdaCallback", "LazyLogs",
           "ModelCheckpoint", "StopTraining", "Telemetry", "TensorBoard",
           "Trainer"]


def __getattr__(name):
    # Telemetry lives in tpu_dist_torch.observe, which imports this
    # package's callbacks: a lazy re-export avoids the cycle.
    if name == "Telemetry":
        from tpu_dist_torch.observe.telemetry import Telemetry

        return Telemetry
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
