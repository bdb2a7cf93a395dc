"""Weights bridge from the reference package to the port.

The only place where parameter names or layouts are translated. The port's
layers register their children under the reference's layer names and keep
its layouts (Dense kernels ``[in, out]``, Conv2D kernels HWIO ``[kh, kw,
in, out]``, embedding tables ``[vocab, dim]``, attention projections
``[d, heads * key_dim]``), so for the transformer and the CNN the
translation is the identity on layouts and a join of the params tree's path
with ``.`` on names. Reads numpy only.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables['params']`` (nested dicts of arrays) -> the
    port's ``state_dict`` (float32 CPU tensors keyed by dotted path)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        arr = np.asarray(node, dtype=np.float32)
        out[".".join(path)] = torch.from_numpy(arr.copy())

    walk(tree, ())
    return out
