"""Training callbacks — the Keras-fit hook surface.

Subset of ``tpu_dist/training/callbacks.py``: the base hook protocol,
:class:`CallbackList`, :class:`History` (always installed, the object
``fit`` returns) and :class:`StopTraining`. The JAX package's ``LazyLogs``
defer the epoch's device-to-host fetch; here the trainer fills plain dicts
once per epoch with ``.item()``, one read per value at the epoch's end.
``ModelCheckpoint``, ``EarlyStopping``, ``JSONLogger``, ``TensorBoard``
and ``LambdaCallback`` come with the slices that port checkpoints and
observability (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence


class Callback:
    model = None  # wired by CallbackList

    def on_train_begin(self) -> None: ...
    def on_train_end(self) -> None: ...
    def on_epoch_begin(self, epoch: int) -> None: ...
    def on_epoch_end(self, epoch: int, logs: dict) -> None: ...
    def on_batch_end(self, step: int, logs: dict) -> None: ...

    #: Set True on subclasses that implement on_batch_end, so the trainer only
    #: pays the per-step device->host sync when someone is listening.
    wants_batches = False


class CallbackList:
    def __init__(self, callbacks: Sequence[Callback], model=None):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.model = model

    @property
    def has_batch_hooks(self) -> bool:
        return any(cb.wants_batches for cb in self.callbacks)

    def on_train_begin(self):
        for cb in self.callbacks:
            cb.on_train_begin()

    def on_train_end(self):
        # Teardown runs in reverse registration order (proper nesting).
        for cb in reversed(self.callbacks):
            cb.on_train_end()

    def on_epoch_begin(self, epoch):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)

    def on_batch_end(self, step, logs):
        for cb in self.callbacks:
            if cb.wants_batches:
                cb.on_batch_end(step, logs)


class History(Callback):
    """Per-epoch log record; ``fit`` returns this (Keras History analog)."""

    def __init__(self):
        self.epoch: list[int] = []
        self.history: dict[str, list] = {}

    def on_epoch_end(self, epoch, logs):
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class StopTraining(Exception):
    """Raised by callbacks to end fit cleanly."""
