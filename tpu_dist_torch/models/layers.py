"""Neural-net layers as ``nn.Module``s — the subset the transformer LM needs.

Counterpart of ``tpu_dist/models/layers.py``. The reference's layers are
immutable descriptions whose ``init(key, in_shape)`` returns a params tree;
here a layer is an ``nn.Module`` whose ``init(gen, in_shape)`` creates its
own parameters (shapes inferred from the input shape, as in the reference)
and returns the output shape. Containers register their children under the
reference's :func:`unique_layer_names`, so a parameter's dotted name in the
port's ``state_dict`` is the path of the same leaf in the reference's params
tree (``block.residual.main.multiheadattention.wq``), and Dense kernels keep
the reference's ``[in, out]`` layout, used as ``x @ W``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.ops import initializers

Shape = tuple[int, ...]

_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation; F.gelu's default is
    # the exact erf form, which drifts from the reference by ~1e-3.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def _activation(name) -> Callable:
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"unknown activation {name!r}; available: "
            f"{sorted(k for k in _ACTIVATIONS if k)}")
    return _ACTIVATIONS[name]


class Layer(nn.Module):
    """A module that creates its parameters in :meth:`init` from the input
    shape (batch dim excluded) and returns its output shape."""

    def init(self, gen: torch.Generator, in_shape: Shape) -> Shape:
        raise NotImplementedError

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def _set_params(self, **tensors: torch.Tensor) -> None:
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


class Dense(Layer):
    """Fully connected on the last axis; kernel ``[in, out]``."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True,
                 kernel_initializer: str = "glorot_uniform"):
        super().__init__()
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer

    def init(self, gen, in_shape):
        din = in_shape[-1]
        self._set_params(kernel=initializers.get(self.kernel_initializer)(
            gen, (din, self.units)))
        if self.use_bias:
            self._set_params(bias=torch.zeros(self.units))
        return (*in_shape[:-1], self.units)

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return _activation(self.activation)(y)


def unique_layer_names(layers: Sequence[Layer]) -> list[str]:
    """kind, kind_1, kind_2, ... — the reference's param-tree keys."""
    import collections

    counts: collections.Counter = collections.Counter()
    names = []
    for layer in layers:
        k = layer.kind
        names.append(k if counts[k] == 0 else f"{k}_{counts[k]}")
        counts[k] += 1
    return names


def init_chain(layers: Iterable[Layer], gen: torch.Generator,
               in_shape: Shape) -> Shape:
    """Initialize a layer chain in order; returns the output shape."""
    shape = tuple(in_shape)
    for layer in layers:
        shape = layer.init(gen, shape)
    return shape


def apply_chain(layers: Iterable[Layer], x):
    for layer in layers:
        x = layer(x)
    return x


class Block(Layer):
    """A named sub-stack of layers; children are registered under
    :func:`unique_layer_names`, so parameters nest under them."""

    def __init__(self, layers: Sequence[Layer] = ()):
        super().__init__()
        for name, layer in zip(unique_layer_names(layers), layers):
            self.add_module(name, layer)

    @property
    def layers(self) -> list[Layer]:
        return list(self._modules.values())

    @property
    def layer_names(self) -> list[str]:
        return list(self._modules.keys())

    def init(self, gen, in_shape):
        return init_chain(self.layers, gen, in_shape)

    def forward(self, x):
        return apply_chain(self.layers, x)


class Residual(Layer):
    """``activation(main(x) + shortcut(x))``; ``shortcut=()`` is the
    identity skip."""

    def __init__(self, main: Sequence[Layer] = (),
                 shortcut: Sequence[Layer] = (),
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.main = nn.ModuleDict(zip(unique_layer_names(main), main))
        self.shortcut = nn.ModuleDict(
            zip(unique_layer_names(shortcut), shortcut))
        self.activation = activation

    def init(self, gen, in_shape):
        out_main = init_chain(self.main.values(), gen, in_shape)
        out_short = init_chain(self.shortcut.values(), gen, in_shape)
        if out_main != out_short:
            raise ValueError(
                f"residual branches disagree: main -> {out_main}, "
                f"shortcut -> {out_short}")
        return out_main

    def forward(self, x):
        y = apply_chain(self.main.values(), x)
        sc = apply_chain(self.shortcut.values(), x)
        return _activation(self.activation)(y + sc)
