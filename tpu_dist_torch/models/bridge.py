"""Weights bridge from the reference package to the port.

The only place where parameter names or layouts are translated. The port's
layers register their children under the reference's layer names and keep
its layouts (Dense kernels ``[in, out]``, Conv2D kernels HWIO ``[kh, kw,
in, out]``, embedding tables ``[vocab, dim]``, attention projections
``[d, heads * key_dim]``), and their state (BatchNorm's ``mean`` and
``var``) as buffers at the state tree's paths, so the translation is the
identity on layouts and a join of each tree's path with ``.`` on names.
Reads numpy only.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables['params']`` (nested dicts of arrays) -> the
    port's parameters (float32 CPU tensors keyed by dotted path)."""
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


def state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables['state']`` -> the port's buffers (CPU tensors
    keyed by dotted path, in the arrays' own dtypes)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        out[".".join(path)] = torch.from_numpy(np.array(node))

    walk(tree, ())
    return out


def variables_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables`` (``{'params': …, 'state': …}``) -> the
    port's whole ``state_dict``: parameters and buffers."""
    return {**params_from_jax(variables["params"]),
            **state_from_jax(variables.get("state") or {})}
