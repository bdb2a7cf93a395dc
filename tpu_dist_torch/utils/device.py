"""The device rule of the port's entry points.

An entry point runs on the CUDA device unless its caller asks for the CPU
with ``device="cpu"`` (as the CPU tests do). Asked for CUDA on a machine
without a GPU, it raises: it never continues silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_dist_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable name of the device a result came from."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
