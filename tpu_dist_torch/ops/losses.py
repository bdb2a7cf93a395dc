"""Loss functions.

Counterpart of ``tpu_dist/ops/losses.py`` in PyTorch: pure functions
returning per-example losses, and :class:`Loss` objects whose call is the
mean over the batch. Integer labels index as int64 (PyTorch's gather);
every loss is computed in the logits' dtype, as the JAX package does.
``SparseCategoricalCrossentropy(from_logits=True, fused=True)`` computes
the loss with the fused cross-entropy kernels (``ops/fused.py``).
"""

from __future__ import annotations

import torch

from tpu_dist_torch.ops.fused import fused_sparse_cross_entropy


def sparse_categorical_crossentropy(logits, labels, *,
                                    from_logits: bool = True):
    """Per-example CE from integer labels: [B, C] x [B] -> [B]. A label in
    ``[-C, 0)`` counts from the end and one outside ``[-C, C)`` gives a NaN
    loss, the JAX package's ``take_along_axis`` (its fill mode), where
    PyTorch's gather would index out of bounds."""
    if from_logits:
        log_probs = torch.log_softmax(logits, dim=-1)
    else:
        log_probs = torch.log(torch.clamp(logits, 1e-7, 1.0))
    c = log_probs.shape[-1]
    labels = labels.long()
    labels = torch.where(labels < 0, labels + c, labels)
    valid = (labels >= 0) & (labels < c)
    picked = torch.gather(log_probs, -1, torch.where(
        valid, labels, 0).unsqueeze(-1)).squeeze(-1)
    return -torch.where(valid, picked, torch.nan)


def categorical_crossentropy(logits, onehot, *, from_logits: bool = True):
    if from_logits:
        log_probs = torch.log_softmax(logits, dim=-1)
    else:
        log_probs = torch.log(torch.clamp(logits, 1e-7, 1.0))
    return -(onehot * log_probs).sum(dim=-1)


def mean_squared_error(preds, targets):
    targets = _align_binary_shapes(preds, torch.as_tensor(targets))
    return torch.mean(torch.square(preds - targets), dim=-1)


def mean_absolute_error(preds, targets):
    targets = _align_binary_shapes(preds, torch.as_tensor(targets))
    return torch.mean(torch.abs(preds - targets), dim=-1)


def _align_binary_shapes(preds, targets):
    """[B] targets against [B, 1] preds (the standard single-logit head):
    insert the trailing axis instead of letting broadcasting silently build
    a [B, B] matrix — the Keras shape-matching behavior."""
    if targets.dim() == preds.dim() - 1 and preds.shape[-1] == 1:
        targets = targets.unsqueeze(-1)
    try:
        ok = preds.shape == torch.broadcast_shapes(preds.shape,
                                                   targets.shape)
    except RuntimeError:  # incompatible ranks/dims
        ok = False
    if not ok:
        raise ValueError(
            f"binary loss/metric shapes disagree: preds {tuple(preds.shape)} "
            f"vs targets {tuple(targets.shape)}")
    return targets


def binary_crossentropy(preds, targets, *, from_logits: bool = False):
    """Per-example BCE averaged over the trailing dim: [B, ...] x [B, ...]
    (or [B] targets against a [B, 1] single-logit head)."""
    targets = _align_binary_shapes(preds, torch.as_tensor(targets))
    targets = targets.to(preds.dtype)
    if from_logits:
        # log-sum-exp form: stable for large |logits|.
        per = (torch.clamp(preds, min=0) - preds * targets
               + torch.log1p(torch.exp(-torch.abs(preds))))
    else:
        p = torch.clamp(preds, 1e-7, 1 - 1e-7)
        per = -(targets * torch.log(p) + (1 - targets) * torch.log1p(-p))
    return per.reshape(per.shape[0], -1).mean(dim=-1)


def huber(preds, targets, *, delta: float = 1.0):
    """Quadratic within ±delta, linear outside — tf.keras.losses.Huber."""
    targets = _align_binary_shapes(preds, torch.as_tensor(targets))
    err = preds - targets
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    per = 0.5 * quad ** 2 + delta * (abs_err - quad)
    return per.reshape(per.shape[0], -1).mean(dim=-1)


class Loss:
    """Callable loss object with a Keras-compatible constructor surface."""

    def __init__(self, fn, name: str):
        self._fn = fn
        self.name = name

    def __call__(self, logits, labels):
        return torch.mean(self._fn(logits, labels))

    def per_example(self, logits, labels):
        return self._fn(logits, labels)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class SparseCategoricalCrossentropy(Loss):
    """tf.keras.losses.SparseCategoricalCrossentropy analog.

    ``fused=True`` computes the per-example loss with
    :func:`~tpu_dist_torch.ops.fused.fused_sparse_cross_entropy`: on CUDA
    logits the forward and backward are one launch each of
    ``csrc/fused_ce.cu`` (or the call raises), on CPU logits their plain
    versions. Requires ``from_logits=True``, as the reference does."""

    def __init__(self, from_logits: bool = False, fused: bool = False):
        if fused and not from_logits:
            raise ValueError("fused CE operates on logits; "
                             "pass from_logits=True")
        if fused:
            fn = fused_sparse_cross_entropy
        else:
            fn = lambda logits, labels: sparse_categorical_crossentropy(
                logits, labels, from_logits=from_logits)
        super().__init__(fn, "sparse_categorical_crossentropy")
        self.from_logits = from_logits
        self.fused = bool(fused)


class CategoricalCrossentropy(Loss):
    def __init__(self, from_logits: bool = False):
        super().__init__(
            lambda logits, onehot: categorical_crossentropy(
                logits, onehot, from_logits=from_logits),
            "categorical_crossentropy")
        self.from_logits = from_logits


class MeanSquaredError(Loss):
    def __init__(self):
        super().__init__(mean_squared_error, "mean_squared_error")


class MeanAbsoluteError(Loss):
    def __init__(self):
        super().__init__(mean_absolute_error, "mean_absolute_error")


class BinaryCrossentropy(Loss):
    def __init__(self, from_logits: bool = False):
        super().__init__(
            lambda preds, targets: binary_crossentropy(
                preds, targets, from_logits=from_logits),
            "binary_crossentropy")
        self.from_logits = from_logits


class Huber(Loss):
    def __init__(self, delta: float = 1.0):
        super().__init__(
            lambda preds, targets: huber(preds, targets, delta=delta),
            "huber")
        self.delta = float(delta)


def get(identifier) -> Loss:
    if isinstance(identifier, Loss):
        return identifier
    # String identifiers resolve with from_logits=False, matching Keras's
    # string-to-loss mapping; logit-output models pass the class with
    # from_logits=True.
    table = {
        "sparse_categorical_crossentropy":
            lambda: SparseCategoricalCrossentropy(from_logits=False),
        "categorical_crossentropy":
            lambda: CategoricalCrossentropy(from_logits=False),
        "mse": MeanSquaredError,
        "mean_squared_error": MeanSquaredError,
        "mae": MeanAbsoluteError,
        "mean_absolute_error": MeanAbsoluteError,
        "binary_crossentropy":
            lambda: BinaryCrossentropy(from_logits=False),
        "huber": Huber,
    }
    if isinstance(identifier, str) and identifier in table:
        return table[identifier]()
    raise ValueError(
        f"unknown loss {identifier!r}; available: {sorted(table)}")
