"""Ops layer: initializers, losses, metrics, optimizers, schedules, and the
hand-written kernels' wrappers (``fused``, ``flash_attention``)."""

from tpu_dist_torch.ops import (initializers, losses, metrics, optimizers,
                                schedules)
from tpu_dist_torch.ops.losses import (BinaryCrossentropy,
                                       CategoricalCrossentropy, Huber, Loss,
                                       MeanAbsoluteError, MeanSquaredError,
                                       SparseCategoricalCrossentropy)
from tpu_dist_torch.ops.metrics import (BinaryAccuracy, CategoricalAccuracy,
                                        Mean, Metric,
                                        SparseCategoricalAccuracy,
                                        SparseTopKCategoricalAccuracy, Sum)
from tpu_dist_torch.ops.optimizers import SGD, Adam, Optimizer
from tpu_dist_torch.ops.schedules import (CosineDecay, ExponentialDecay,
                                          LearningRateSchedule,
                                          PiecewiseConstantDecay,
                                          WarmupCosine)

__all__ = [
    "initializers", "losses", "metrics", "optimizers", "schedules",
    "BinaryCrossentropy", "CategoricalCrossentropy", "Huber",
    "MeanAbsoluteError", "Loss", "MeanSquaredError",
    "SparseCategoricalCrossentropy",
    "BinaryAccuracy", "CategoricalAccuracy", "Mean", "Metric",
    "SparseTopKCategoricalAccuracy", "Sum", "SparseCategoricalAccuracy",
    "SGD", "Adam", "Optimizer",
    "CosineDecay", "ExponentialDecay", "LearningRateSchedule",
    "PiecewiseConstantDecay", "WarmupCosine",
]
