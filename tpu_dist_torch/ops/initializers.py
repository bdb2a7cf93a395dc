"""Parameter initializers (Keras-default-compatible), on a ``torch.Generator``.

Counterpart of ``tpu_dist/ops/initializers.py``. JAX's threefry and torch's
Philox give different numbers from the same seed, so the port never tries to
re-derive the reference's weights: parity runs load them through
``models/bridge.py``.
"""

from __future__ import annotations

import math

import torch


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # Conv kernels (H, W, Cin, Cout): receptive field x channels.
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def zeros(gen: torch.Generator, shape, dtype=torch.float32):
    del gen
    return torch.zeros(shape, dtype=dtype)


def ones(gen: torch.Generator, shape, dtype=torch.float32):
    del gen
    return torch.ones(shape, dtype=dtype)


def glorot_uniform(gen: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(tuple(shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                    generator=gen)


def get(name: str):
    table = {
        "zeros": zeros,
        "ones": ones,
        "glorot_uniform": glorot_uniform,
    }
    if name not in table:
        raise ValueError(
            f"unknown initializer {name!r}; available: {sorted(table)}")
    return table[name]
