"""Learning-rate schedules: functions of the step, evaluated on the device.

Copy of ``tpu_dist/ops/schedules.py`` in PyTorch. A schedule is a callable
``schedule(step) -> lr`` of torch ops: given the optimizer's step counter
(a 0-d tensor on the parameters' device) it returns a 0-d fp32 tensor
there, so the learning rate changes every step with no host round trip.
Step counting is TF-compatible: the first update evaluates ``schedule(0)``.

    opt = SGD(learning_rate=ExponentialDecay(0.01, decay_steps=1000,
                                             decay_rate=0.5))
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


class LearningRateSchedule:
    """Base: subclasses implement ``__call__(step) -> lr`` with torch ops
    only (no Python control flow on ``step``, which lives on the device)."""

    def __call__(self, step):
        raise NotImplementedError

    def __repr__(self):
        attrs = ", ".join(f"{k}={v}" for k, v in vars(self).items())
        return f"{type(self).__name__}({attrs})"


class ExponentialDecay(LearningRateSchedule):
    """lr * decay_rate ** (step / decay_steps); ``staircase`` floors the
    exponent to whole decay periods."""

    def __init__(self, initial_learning_rate: float, decay_steps: int,
                 decay_rate: float, staircase: bool = False):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)

    def __call__(self, step):
        p = _as_f32(step) / self.decay_steps
        if self.staircase:
            p = torch.floor(p)
        return self.initial_learning_rate * torch.pow(self.decay_rate, p)


class CosineDecay(LearningRateSchedule):
    """Cosine annealing from the initial lr to ``alpha * initial`` over
    ``decay_steps``, constant afterwards."""

    def __init__(self, initial_learning_rate: float, decay_steps: int,
                 alpha: float = 0.0):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.alpha = float(alpha)

    def __call__(self, step):
        t = torch.clamp(_as_f32(step), max=float(self.decay_steps))
        cos = 0.5 * (1 + torch.cos(math.pi * t / self.decay_steps))
        return self.initial_learning_rate * (
            (1 - self.alpha) * cos + self.alpha)


class PiecewiseConstantDecay(LearningRateSchedule):
    """values[i] while step <= boundaries[i-1]..boundaries[i]; TF semantics:
    len(values) == len(boundaries) + 1."""

    def __init__(self, boundaries: Sequence[int], values: Sequence[float]):
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                f"need len(values) == len(boundaries) + 1, got "
                f"{len(values)} values / {len(boundaries)} boundaries")
        self.boundaries = [int(b) for b in boundaries]
        self.values = [float(v) for v in values]

    def __call__(self, step):
        step = torch.as_tensor(step)
        # Index = number of boundaries the step has passed (step > b). Only
        # device ops on Python scalars, no copy from the host, so a CUDA
        # graph can capture the schedule.
        passed = torch.zeros((), dtype=torch.int64, device=step.device)
        for b in self.boundaries:
            passed = passed + (step > b)
        lr = torch.full((), self.values[0], dtype=torch.float32,
                        device=step.device)
        for i, v in enumerate(self.values[1:], 1):
            lr = torch.where(passed == i, v, lr)
        return lr


class WarmupCosine(LearningRateSchedule):
    """Linear warmup to ``peak`` over ``warmup_steps``, then cosine decay to
    ``alpha * peak`` over the remaining ``decay_steps``."""

    def __init__(self, peak_learning_rate: float, warmup_steps: int,
                 decay_steps: int, alpha: float = 0.0):
        self.peak_learning_rate = float(peak_learning_rate)
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = int(decay_steps)
        self.alpha = float(alpha)

    def __call__(self, step):
        t = _as_f32(step)
        warm = self.peak_learning_rate * t / max(self.warmup_steps, 1)
        d = torch.clamp((t - self.warmup_steps) / max(self.decay_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * d))
        decayed = self.peak_learning_rate * ((1 - self.alpha) * cos
                                             + self.alpha)
        return torch.where(t < self.warmup_steps, warm, decayed)


def resolve(learning_rate):
    """(value, is_schedule): accept float or LearningRateSchedule/callable."""
    if isinstance(learning_rate, LearningRateSchedule):
        return learning_rate, True
    if callable(learning_rate):
        return learning_rate, True
    return float(learning_rate), False
