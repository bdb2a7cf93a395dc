"""Mixed-precision policy: bfloat16 compute, float32 params and state.

Counterpart of ``tpu_dist/models/policy.py``. The model containers cast
inputs to :func:`compute_dtype` on entry and outputs back to float32, and
every layer casts its params to the activation dtype at use, so a policy
flip needs no model change.

    tpu_dist_torch.models.policy.set_policy("mixed_bfloat16")  # or "float32"
"""

from __future__ import annotations

import threading

import torch

_POLICIES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "mixed_bfloat16": torch.bfloat16,
}

_lock = threading.Lock()
_current = "float32"


def set_policy(name: str) -> None:
    global _current
    if name not in _POLICIES:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(_POLICIES)}")
    with _lock:
        _current = name


def compute_dtype() -> torch.dtype:
    return _POLICIES[_current]
