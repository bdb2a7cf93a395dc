"""Optimizers: Keras-style update rules over lists of parameter tensors.

Counterpart of ``tpu_dist/ops/optimizers.py``. The JAX package's optimizers
are pure: ``update(grads, state, params) -> (new_params, new_state)``. Here,
in PyTorch's idiom, :meth:`Optimizer.update` changes the parameters and the
optimizer state in place under ``torch.no_grad()`` and returns the state.
``params``, ``grads`` and every per-parameter state are lists in the same
order (the trainer's ``list(model.parameters())``); the state's shapes are
the JAX package's: constant-lr SGD keeps ``()`` or a velocity list, a
scheduled lr adds the step counter (:class:`SGDState`), Adam keeps
:class:`AdamState`. Step counters are 0-d int32 tensors on the parameters'
device, so neither a schedule nor Adam's bias correction reads the host.

``OptaxWrapper`` has no PyTorch counterpart and is left out.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tpu_dist_torch.ops import schedules
from tpu_dist_torch.ops.fused import (adam_tables, fused_adam_apply,
                                      fused_adam_plain, fused_sgd_apply,
                                      fused_sgd_plain, sgd_tables)


class Optimizer:
    #: Keras-style clipping knobs, applied to the gradients before the
    #: update rule — set via constructor kwargs on the concrete optimizers.
    #: At most one may be set (the Keras contract).
    clipnorm: float | None = None
    clipvalue: float | None = None
    global_clipnorm: float | None = None

    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, grads, state, params) -> Any:
        """Updates ``params`` (and ``state``) in place; returns the state."""
        raise NotImplementedError

    def _set_clipping(self, clipnorm=None, clipvalue=None,
                      global_clipnorm=None):
        if sum(x is not None for x in
               (clipnorm, clipvalue, global_clipnorm)) > 1:
            raise ValueError(
                "at most one of clipnorm/clipvalue/global_clipnorm may be "
                "set")
        for name, x in (("clipnorm", clipnorm), ("clipvalue", clipvalue),
                        ("global_clipnorm", global_clipnorm)):
            if x is not None and float(x) <= 0:
                raise ValueError(f"{name} must be > 0, got {x}")
        self.clipnorm = None if clipnorm is None else float(clipnorm)
        self.clipvalue = None if clipvalue is None else float(clipvalue)
        self.global_clipnorm = (None if global_clipnorm is None
                                else float(global_clipnorm))

    def _clip(self, grads):
        """Keras semantics: clipnorm rescales each tensor to its own norm
        cap; global_clipnorm rescales everything by the joint norm;
        clipvalue clamps elementwise. Returns new tensors."""
        if self.clipvalue is not None:
            c = self.clipvalue
            return [g.clamp(-c, c) for g in grads]
        if self.clipnorm is not None:
            c = self.clipnorm

            def per_tensor(g):
                n = torch.sqrt(torch.sum(torch.square(g)))
                return g * torch.clamp(c / torch.clamp(n, min=1e-12),
                                       max=1.0)

            return [per_tensor(g) for g in grads]
        if self.global_clipnorm is not None:
            c = self.global_clipnorm
            n = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            scale = torch.clamp(c / torch.clamp(n, min=1e-12), max=1.0)
            return [g * scale for g in grads]
        return list(grads)

    def __repr__(self):
        attrs = ", ".join(f"{k}={v}" for k, v in vars(self).items()
                          if not k.startswith("_"))
        return f"{type(self).__name__}({attrs})"


def _step_counter(params) -> torch.Tensor:
    device = params[0].device if params else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=device)


class SGDState(NamedTuple):
    """State when the lr is a schedule: step counter + velocity list
    (``()`` velocity when momentum is off). Constant-lr SGD keeps the
    legacy stateless/velocity-only shapes."""

    step: torch.Tensor
    velocity: Any


class SGD(Optimizer):
    """SGD with optional momentum/Nesterov — tf.keras SGD analog.
    ``learning_rate`` accepts a float or a schedule (evaluated on the
    device per step; TF semantics: first update sees schedule(0)).
    ``fused=True`` updates every parameter in one launch of the fused SGD
    kernel (``ops/fused.py``), a constant or a scheduled learning rate
    alike: the kernel reads the rate on the device. (The JAX package keeps
    a schedule on its jnp path because its TPU kernel bakes the rate in as
    a constant; both give the same update.) The optimizer keeps the
    kernel's leaf table beside its state, built on the first fused update
    and reused while the same tensors come back (``ops/fused.py``), so a
    fused update of tensors it has seen can be captured in a CUDA graph.
    Otherwise the same math runs leaf by leaf
    (:func:`~tpu_dist_torch.ops.fused.fused_sgd_plain`)."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.0,
                 nesterov: bool = False, clipnorm=None, clipvalue=None,
                 global_clipnorm=None, fused: bool = False):
        self.learning_rate, self._scheduled = schedules.resolve(learning_rate)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.fused = bool(fused)
        self._set_clipping(clipnorm, clipvalue, global_clipnorm)
        self._tables = sgd_tables()

    def init(self, params):
        vel = (() if self.momentum == 0.0
               else [torch.zeros_like(p) for p in params])
        if self._scheduled:
            return SGDState(step=_step_counter(params), velocity=vel)
        return vel

    def update(self, grads, state, params):
        with torch.no_grad():
            grads = self._clip(grads)
            if self._scheduled:
                lr = self.learning_rate(state.step)
                vel = state.velocity
            else:
                lr = self.learning_rate
                vel = state
            vel = vel if self.momentum != 0.0 else None
            kw = dict(learning_rate=lr, momentum=self.momentum,
                      nesterov=self.nesterov)
            if self.fused:
                fused_sgd_apply(params, grads, vel, tables=self._tables, **kw)
            else:
                fused_sgd_plain(params, grads, vel, **kw)
            if self._scheduled:
                state.step.add_(1)
        return state


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class Adam(Optimizer):
    """Adam with Keras's ε = 1e-7 (PyTorch's default is 1e-8).
    ``learning_rate`` accepts a float or a schedule (evaluated at the
    0-based completed-step count). The step scale ``lr·sqrt(1 − b2^t)/
    (1 − b1^t)`` is computed in fp32 on the device, as the JAX package
    does: by the plain version's ops, or inside the kernel from the step
    counter. ``fused=True`` updates every parameter in one launch of the
    fused kernel (``ops/fused.py``), on a leaf table kept beside the state
    as for :class:`SGD`; otherwise the same math runs leaf by leaf
    (:func:`~tpu_dist_torch.ops.fused.fused_adam_plain`)."""

    def __init__(self, learning_rate=0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-7,
                 clipnorm=None, clipvalue=None, global_clipnorm=None,
                 fused: bool = False):
        self.learning_rate, self._scheduled = schedules.resolve(learning_rate)
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.epsilon = float(epsilon)
        self.fused = bool(fused)
        self._set_clipping(clipnorm, clipvalue, global_clipnorm)
        self._tables = adam_tables()

    def init(self, params):
        z = lambda: [torch.zeros_like(p) for p in params]
        return AdamState(step=_step_counter(params), mu=z(), nu=z())

    def update(self, grads, state, params):
        with torch.no_grad():
            grads = self._clip(grads)
            lr = (self.learning_rate(state.step) if self._scheduled
                  else self.learning_rate)
            state.step.add_(1)
            kw = dict(step=state.step, learning_rate=lr, beta_1=self.beta_1,
                      beta_2=self.beta_2, epsilon=self.epsilon)
            if self.fused:
                fused_adam_apply(params, grads, state.mu, state.nu,
                                 tables=self._tables, **kw)
            else:
                fused_adam_plain(params, grads, state.mu, state.nu, **kw)
        return state


def get(identifier) -> Optimizer:
    if isinstance(identifier, Optimizer):
        return identifier
    table = {"sgd": SGD, "adam": Adam}
    if isinstance(identifier, str) and identifier.lower() in table:
        return table[identifier.lower()]()
    raise ValueError(
        f"unknown optimizer {identifier!r}; available: {sorted(table)}")
