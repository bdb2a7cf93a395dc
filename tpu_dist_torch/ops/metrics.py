"""Metrics as device-resident state.

Counterpart of ``tpu_dist/ops/metrics.py``. A metric's state is the JAX
package's ``{"total", "count"}`` dict of fp32 scalars, here 0-d tensors on
the model's device that :meth:`Metric.update` adds to in place, so the hot
loop never reads the host; the division happens only at read time
(:meth:`Metric.result`), so epoch metrics weight every sample equally like
Keras's stateful metrics.
"""

from __future__ import annotations

from typing import Any, MutableMapping

import torch

from tpu_dist_torch.ops.losses import _align_binary_shapes

MetricState = MutableMapping[str, Any]


def _add(state: MetricState, hits: torch.Tensor) -> MetricState:
    state["total"] += hits.sum().to(torch.float32)
    state["count"] += float(hits.numel())
    return state


class Metric:
    name: str

    def init(self, device=None) -> MetricState:
        return {"total": torch.zeros((), dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, state: MetricState, logits, labels) -> MetricState:
        """Adds this batch to ``state`` in place; returns it."""
        raise NotImplementedError

    def result(self, state: MetricState):
        return state["total"] / torch.clamp(state["count"], min=1.0)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class SparseCategoricalAccuracy(Metric):
    """tf.keras.metrics.SparseCategoricalAccuracy analog."""

    def __init__(self, name: str = "accuracy"):
        self.name = name

    def update(self, state, logits, labels):
        return _add(state, torch.argmax(logits, dim=-1) == labels.long())


class CategoricalAccuracy(Metric):
    """Accuracy against one-hot labels: argmax(logits) == argmax(labels)."""

    def __init__(self, name: str = "categorical_accuracy"):
        self.name = name

    def update(self, state, logits, onehot):
        return _add(state, torch.argmax(logits, dim=-1)
                    == torch.argmax(onehot, dim=-1))


class BinaryAccuracy(Metric):
    """Thresholded accuracy for sigmoid/binary heads."""

    def __init__(self, threshold: float = 0.5, name: str = "binary_accuracy"):
        self.threshold = float(threshold)
        self.name = name

    def update(self, state, preds, labels):
        labels = _align_binary_shapes(preds, torch.as_tensor(labels))
        return _add(state, (preds > self.threshold).to(torch.int32)
                    == labels.to(torch.int32))


class SparseTopKCategoricalAccuracy(Metric):
    """Label within the top-k logits — tf.keras SparseTopKCategoricalAccuracy
    (default k=5)."""

    def __init__(self, k: int = 5, name: str = "top_k_accuracy"):
        self.k = int(k)
        self.name = name

    def update(self, state, logits, labels):
        top = torch.topk(logits, self.k, dim=-1).indices
        return _add(state, (top == labels.long().unsqueeze(-1)).any(dim=-1))


class Mean(Metric):
    """Streaming mean — used for the loss channel of the progress bar."""

    def __init__(self, name: str = "mean"):
        self.name = name

    def update(self, state, value, weight=None):
        w = 1.0 if weight is None else weight
        state["total"] += torch.as_tensor(value).to(torch.float32) * w
        state["count"] += w
        return state


class Sum(Mean):
    """Streaming sum (result ignores the count)."""

    def __init__(self, name: str = "sum"):
        self.name = name

    def result(self, state):
        return state["total"]


def get(identifier) -> Metric:
    if isinstance(identifier, Metric):
        return identifier
    table = {
        "accuracy": lambda: SparseCategoricalAccuracy(),
        "sparse_categorical_accuracy": lambda: SparseCategoricalAccuracy(
            name="sparse_categorical_accuracy"),
        "categorical_accuracy": CategoricalAccuracy,
        "binary_accuracy": BinaryAccuracy,
        "sparse_top_k_categorical_accuracy": SparseTopKCategoricalAccuracy,
        "top_k_accuracy": SparseTopKCategoricalAccuracy,
    }
    if isinstance(identifier, str) and identifier in table:
        return table[identifier]()
    raise ValueError(
        f"unknown metric {identifier!r}; available: {sorted(table)}")
