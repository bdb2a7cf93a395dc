"""Model container: ``Sequential`` — init from a seed and the forward pass.

Counterpart of ``tpu_dist/models/model.py`` (``Sequential``). The training
surface (``compile``/``fit``/``save``) comes with the training slice of the
port. Children are registered under the reference's layer names, so the
dotted names of :meth:`state_dict` are the reference's params-tree paths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_dist_torch.models.layers import (Layer, apply_chain, init_chain,
                                          unique_layer_names)
from tpu_dist_torch.models.policy import compute_dtype


class Sequential(nn.Module):
    """Linear layer stack. Parameters are created at construction from
    ``seed`` when ``input_shape`` is known (on the CPU; move the model with
    ``.to(device)``)."""

    def __init__(self, layers: Sequence[Layer], *,
                 input_shape: Optional[tuple] = None,
                 name: str = "sequential", seed: int = 0):
        super().__init__()
        if not layers:
            raise ValueError("Sequential needs at least one layer")
        for lname, layer in zip(unique_layer_names(layers), layers):
            self.add_module(lname, layer)
        self.input_shape = input_shape
        self.name = name
        self.output_shape = None
        if input_shape is not None:
            self.init(seed)

    @property
    def layers(self) -> list[Layer]:
        return list(self._modules.values())

    @property
    def layer_names(self) -> list[str]:
        return list(self._modules.keys())

    def init(self, seed: int = 0) -> dict:
        """(Re)create every parameter from ``seed``; the model keeps the
        device its parameters were on. Returns :attr:`variables`."""
        if self.input_shape is None:
            raise ValueError(f"{self.name}: input_shape unknown")
        device = next((p.device for p in self.parameters()), None)
        gen = torch.Generator().manual_seed(int(seed))
        self.output_shape = init_chain(self.layers, gen,
                                       tuple(self.input_shape))
        if device is not None:
            self.to(device)
        return self.variables

    def forward(self, x):
        # Mixed-precision entry/exit casts (policy.py): activations run in
        # the compute dtype, the returned logits in float32.
        dtype = compute_dtype()
        if x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)
        y = apply_chain(self.layers, x)
        return y.float() if y.is_floating_point() else y

    @property
    def variables(self) -> dict:
        """``{'params': nested dict of tensors, 'state': {}}`` — the
        reference's variables layout."""
        params: dict = {}
        for dotted, p in self.named_parameters():
            *path, leaf = dotted.split(".")
            node = params
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p.detach()
        return {"params": params, "state": {}}

    def load_jax_params(self, tree: dict) -> None:
        """Load the reference model's ``variables['params']`` (nested dicts
        of numpy arrays) into this model, in place."""
        from tpu_dist_torch.models.bridge import params_from_jax

        self.load_state_dict(params_from_jax(tree), strict=True)
