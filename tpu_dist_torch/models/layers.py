"""Neural-net layers as ``nn.Module``s.

Counterpart of ``tpu_dist/models/layers.py``. The reference's layers are
immutable descriptions whose ``init(key, in_shape)`` returns a params and a
state tree; here a layer is an ``nn.Module`` whose ``init(gen, in_shape)``
creates its own parameters and state buffers (shapes inferred from the
input shape, as in the reference) and returns the output shape. Containers
register their children under the reference's :func:`unique_layer_names`,
so a parameter's dotted name in the port's ``state_dict`` is the path of
the same leaf in the reference's params tree
(``block.residual.main.multiheadattention.wq``) and a buffer's is its path
in the reference's state tree (``block.residual.main.batchnormalization.
mean``). Kernels keep the reference's layouts: Dense ``[in, out]``, used as
``x @ W``, and Conv2D HWIO over NHWC activations (``F.conv2d`` sees them
through permuted views; the JAX package leaves convolutions, pooling and
BatchNorm to XLA, so the port leaves them to PyTorch's own operators).

Where the reference's ``apply`` takes ``training=``, a layer here follows
``nn.Module.training`` (the trainer sets it: train mode in the step, eval
mode in ``evaluate`` and ``predict``). Where it takes ``rng``, a Dropout
draws from its ``generator``, which the trainer hands it.
"""

from __future__ import annotations

import functools
import inspect
import math
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
    shape (batch dim excluded) and returns its output shape.

    Every subclass's constructor records the arguments it was called with
    (defaults included): they are the reference layer's dataclass fields,
    under the same names and with the values as given (``kernel_size=3``,
    not the ``(3, 3)`` the layer computes with), which :meth:`config`
    returns for ``models/serialize.py``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is None:
            return
        signature = inspect.signature(init)

        @functools.wraps(init)
        def recording_init(self, *args, **kw):
            init(self, *args, **kw)
            bound = signature.bind(self, *args, **kw)
            bound.apply_defaults()
            # The most derived constructor records last, so its fields win.
            self._fields = dict(list(bound.arguments.items())[1:])

        cls.__init__ = recording_init

    def config(self) -> dict:
        """The reference layer's fields: ``{name: value}``, nested layers
        as layers."""
        return dict(getattr(self, "_fields", {}))

    def init(self, gen: torch.Generator, in_shape: Shape) -> Shape:
        raise NotImplementedError

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def _set_params(self, **tensors: torch.Tensor) -> None:
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))

    def _set_state(self, **tensors: torch.Tensor) -> None:
        """Register the reference's ``state`` leaves as buffers."""
        for name, t in tensors.items():
            self.register_buffer(name, t)


class Dense(Layer):
    """Fully connected on the last axis; kernel ``[in, out]``. Under a
    model axis, :attr:`shard` (``parallel/tensor.DenseShard``) runs this
    process's column or row slice with its collectives."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True,
                 kernel_initializer: str = "glorot_uniform"):
        super().__init__()
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.shard = None

    def init(self, gen, in_shape):
        din = in_shape[-1]
        self._set_params(kernel=initializers.get(self.kernel_initializer)(
            gen, (din, self.units)))
        if self.use_bias:
            self._set_params(bias=torch.zeros(self.units))
        return (*in_shape[:-1], self.units)

    def forward(self, x):
        if self.shard is not None:
            return self.shard(self, x)
        y = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
        return _activation(self.activation)(y)


def _pair(v) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _out_size(n: int, window: int, stride: int, padding: str) -> int:
    """The reference's output-size rule (``layers.py:107-112, 215-223``)."""
    if padding.upper() == "SAME":
        return -(-n // stride)
    return (n - window) // stride + 1


def _same_pads(n: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's / TF's SAME padding of one axis: the odd element at the end."""
    total = max((-(-n // stride) - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, window, strides, value: float = 0.0):
    """NCHW ``x`` padded for a SAME window of ``window`` at ``strides``."""
    (top, bottom), (left, right) = (
        _same_pads(x.shape[2], window[0], strides[0]),
        _same_pads(x.shape[3], window[1], strides[1]))
    return F.pad(x, (left, right, top, bottom), value=value)


def _check_padding(padding: str) -> str:
    if padding.upper() not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
    return padding.upper()


class Conv2D(Layer):
    """2-D convolution over NHWC inputs with an HWIO kernel ``[kh, kw, in,
    out]``, the reference's layouts; ``valid`` or ``same`` padding."""

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation: Optional[str] = None,
                 use_bias: bool = True,
                 kernel_initializer: str = "glorot_uniform"):
        super().__init__()
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _check_padding(padding)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer

    def init(self, gen, in_shape):
        h, w, cin = in_shape
        kh, kw = self.kernel_size
        self._set_params(kernel=initializers.get(self.kernel_initializer)(
            gen, (kh, kw, cin, self.filters)))
        if self.use_bias:
            self._set_params(bias=torch.zeros(self.filters))
        sh, sw = self.strides
        return (_out_size(h, kh, sh, self.padding),
                _out_size(w, kw, sw, self.padding), self.filters)

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)               # NCHW view of NHWC memory
        if self.padding == "SAME":
            xc = _pad_same(xc, self.kernel_size, self.strides)
        y = F.conv2d(xc, self.kernel.to(x.dtype).permute(3, 2, 0, 1),
                     self.bias.to(x.dtype) if self.use_bias else None,
                     stride=self.strides)
        return _activation(self.activation)(y.permute(0, 2, 3, 1))


class MaxPooling2D(Layer):
    """Max pool over NHWC inputs; ``strides`` default to ``pool_size``, the
    reference's default ``pool_size=2``."""

    def __init__(self, pool_size=2, strides=None, padding: str = "valid"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = _check_padding(padding)

    def init(self, gen, in_shape):
        h, w, c = in_shape
        (ph, pw), (sh, sw) = self.pool_size, self.strides
        return (_out_size(h, ph, sh, self.padding),
                _out_size(w, pw, sw, self.padding), c)

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            xc = _pad_same(xc, self.pool_size, self.strides, -math.inf)
        y = F.max_pool2d(xc, self.pool_size, self.strides)
        return y.permute(0, 2, 3, 1)


class AveragePooling2D(MaxPooling2D):
    """Average pool over NHWC inputs. Under SAME padding each window is
    divided by the count of its valid elements (Keras's rule), not by the
    window's size."""

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "VALID":
            return F.avg_pool2d(xc, self.pool_size,
                                self.strides).permute(0, 2, 3, 1)
        summed = F.avg_pool2d(_pad_same(xc, self.pool_size, self.strides),
                              self.pool_size, self.strides,
                              divisor_override=1)
        ones = x.new_ones((1, 1, *xc.shape[2:]))
        counts = F.avg_pool2d(_pad_same(ones, self.pool_size, self.strides),
                              self.pool_size, self.strides,
                              divisor_override=1)
        return (summed / counts).permute(0, 2, 3, 1)


class GlobalAveragePooling2D(Layer):
    """``[B, H, W, C] -> [B, C]``, the mean over H and W."""

    def init(self, gen, in_shape):
        h, w, c = in_shape
        return (c,)

    def forward(self, x):
        return x.mean(dim=(1, 2))


class Flatten(Layer):
    """``[B, ...] -> [B, prod(...)]`` in the NHWC order of the activations,
    so the next Dense kernel's rows line up with the reference's."""

    def init(self, gen, in_shape):
        return (math.prod(in_shape),)

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(Layer):
    """An activation by name, as its own layer."""

    def __init__(self, activation: str = "relu"):
        super().__init__()
        self.activation = activation

    def init(self, gen, in_shape):
        return in_shape

    def forward(self, x):
        return _activation(self.activation)(x)


def ReLU() -> Activation:
    """``Activation("relu")``, the reference's factory."""
    return Activation("relu")


class _SyncMoments(torch.autograd.Function):
    """BatchNorm's normalisation over the global batch of a process group
    (the reference's one ``jit`` over the sharded batch takes its moments
    over the whole batch). Forward: one all-reduce of ``[Σx, n]`` per
    channel for the mean, then one of the centred ``Σ(x − mean)²`` for the
    variance, which centres first as the reference's ``jnp.var`` does
    (``Σx²/n − mean²`` cancels in fp32 on off-centre data); backward: one
    all-reduce of ``[Σdy, Σdy·x̂]``, so every process gets the gradient of
    the summed losses with respect to its own rows. Returns ``(x̂, mean,
    var)``; the moments are not differentiated (they only update the
    running state)."""

    @staticmethod
    def forward(ctx, xf, epsilon, group):
        from tpu_dist_torch.parallel import collectives

        c = xf.shape[-1]
        flat = xf.reshape(-1, c)
        sums = torch.cat([flat.sum(0), flat.new_full((1,), flat.shape[0])])
        collectives.all_reduce([sums], collectives.ReduceOp.SUM, group=group)
        n = sums[c:]
        mean = sums[:c] / n
        centred = (flat - mean).square().sum(0)
        collectives.all_reduce([centred], collectives.ReduceOp.SUM,
                               group=group)
        var = centred / n
        inv = torch.rsqrt(var + epsilon)
        xhat = (xf - mean) * inv
        ctx.save_for_backward(xhat, inv, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return xhat, mean, var

    @staticmethod
    def backward(ctx, dxhat, _dmean, _dvar):
        from tpu_dist_torch.parallel import collectives

        xhat, inv, n = ctx.saved_tensors
        c = xhat.shape[-1]
        sums = torch.cat([dxhat.reshape(-1, c).sum(0),
                          (dxhat * xhat).reshape(-1, c).sum(0)])
        collectives.all_reduce([sums], collectives.ReduceOp.SUM,
                               group=ctx.group)
        dx = inv * (dxhat - sums[:c] / n - xhat * (sums[c:] / n))
        return dx, None, None


class BatchNormalization(Layer):
    """Batch norm over the last (channel) axis with running statistics in
    the buffers ``mean`` and ``var`` (float32 always).

    Train mode normalises with the batch's moments over every other axis,
    computed in float32 whatever the activation dtype, and updates the
    running state as the reference does: ``m * old + (1 - m) * batch``,
    with the biased variance (``F.batch_norm`` would update with the
    unbiased one, and weight the batch by ``momentum``). Eval mode
    normalises with the running state. The output is cast back to the
    input's dtype. With ``synchronized`` set (the trainer sets it in a
    process group), the moments and their gradients are the global
    batch's (:class:`_SyncMoments`), over the processes of ``sync_group``
    (None: all; the trainer sets the replicas' group)."""

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 center: bool = True, scale: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.center = center
        self.scale = scale
        self.synchronized = False
        self.sync_group = None

    def init(self, gen, in_shape):
        c = in_shape[-1]
        if self.scale:
            self._set_params(gamma=torch.ones(c))
        if self.center:
            self._set_params(beta=torch.zeros(c))
        self._set_state(mean=torch.zeros(c), var=torch.ones(c))
        return in_shape

    def forward(self, x):
        xf = x.float()
        if self.training:
            if self.synchronized:
                y, mean, var = _SyncMoments.apply(xf, self.epsilon,
                                                  self.sync_group)
            else:
                var, mean = torch.var_mean(xf, dim=tuple(range(x.dim() - 1)),
                                           correction=0)
                y = (xf - mean) * torch.rsqrt(var + self.epsilon)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            y = (xf - self.mean) * torch.rsqrt(self.var + self.epsilon)
        if self.scale:
            y = y * self.gamma
        if self.center:
            y = y + self.beta
        return y.to(x.dtype)


class Dropout(Layer):
    """Zeroes each element with probability ``rate`` in train mode and
    scales the rest by ``1 / (1 - rate)``; the identity in eval mode. The
    mask is drawn from :attr:`generator` (the trainer's, on the model's
    device, seeded by ``fit(seed=)``)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def init(self, gen, in_shape):
        return in_shape

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout needs a generator during training; "
                             "fit() hands it one")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


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
