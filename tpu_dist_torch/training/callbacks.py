"""Training callbacks — the Keras-fit hook surface.

Subset of ``tpu_dist/training/callbacks.py``: the base hook protocol,
:class:`CallbackList`, :class:`History` (always installed, the object
``fit`` returns), :class:`StopTraining`, :class:`ModelCheckpoint`,
:class:`EarlyStopping` and :class:`LambdaCallback`. The JAX package's
``LazyLogs`` defer the epoch's device-to-host fetch; here the trainer fills
plain dicts once per epoch with ``.item()``, one read per value at the
epoch's end. ``JSONLogger`` and ``TensorBoard`` come with the observability
item of ``ROADMAP.md``'s queue 1 (item 19).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

logger = logging.getLogger("tpu_dist_torch.callbacks")


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


class ModelCheckpoint(Callback):
    """Chief-only checkpoint writes each epoch (``training/checkpoint.py``;
    the step is the epoch). ``save_best_only`` saves only when ``monitor``
    improves in ``mode`` (``"min"`` or ``"max"``); ``max_to_keep`` keeps
    the newest steps. ``async_save=True`` (the default) goes through an
    :class:`~tpu_dist_torch.training.checkpoint.AsyncCheckpointer`: the
    epoch's end pays the snapshot, the write overlaps the next epoch, and
    a write error surfaces at the next save or at the end of training,
    where it is absorbed: one lost checkpoint, logged, never a dead run.
    ``on_train_end`` drains the writer. ``sharded=True`` raises: the
    sharded layout comes with item 18 of ``ROADMAP.md``'s queue 1."""

    def __init__(self, directory: str, *, save_best_only: bool = False,
                 monitor: str = "loss", mode: str = "min",
                 max_to_keep: Optional[int] = None, async_save: bool = True,
                 sharded: bool = False):
        from tpu_dist_torch.training.checkpoint import _no_sharded

        _no_sharded(sharded)
        self.directory = directory
        self.save_best_only = save_best_only
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.sharded = sharded
        self._best: Optional[float] = None
        self._ckpt = None

    def on_train_begin(self):
        if self.async_save and self._ckpt is None:
            from tpu_dist_torch.training import checkpoint

            self._ckpt = checkpoint.AsyncCheckpointer(
                self.directory, max_to_keep=self.max_to_keep)

    def on_epoch_end(self, epoch, logs):
        from tpu_dist_torch.training import checkpoint

        if self.save_best_only:
            current = logs.get(self.monitor)
            if current is None:
                logger.warning("ModelCheckpoint: monitor %r not in logs %s",
                               self.monitor, sorted(logs))
                return
            better = (self._best is None
                      or (current < self._best if self.mode == "min"
                          else current > self._best))
            if not better:
                return
            self._best = current
        try:
            if self._ckpt is not None:
                self._ckpt.save_async(self.model, step=epoch)
            else:
                checkpoint.save(self.directory, self.model, step=epoch,
                                max_to_keep=self.max_to_keep)
        except OSError as exc:
            self._write_failed(getattr(exc, "checkpoint_step", epoch), exc)

    def on_train_end(self):
        if self._ckpt is None:
            return
        ckpt, self._ckpt = self._ckpt, None
        try:
            ckpt.close()
        except OSError as exc:
            self._write_failed(getattr(exc, "checkpoint_step", None), exc)

    def _write_failed(self, step, exc) -> None:
        # A failed write costs one checkpoint interval, never the run: the
        # training state is still live, and the next epoch saves again.
        logger.warning("ModelCheckpoint: step %s write failed (%s); "
                       "continuing without it", step, exc)


class EarlyStopping(Callback):
    """Stops ``fit`` (:class:`StopTraining`) once ``monitor`` has not
    improved by more than ``min_delta`` in ``mode`` for more than
    ``patience`` epochs; ``stopped_epoch`` records where."""

    def __init__(self, monitor: str = "loss", patience: int = 3,
                 mode: str = "min", min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self._best: Optional[float] = None
        self._wait = 0
        self.stopped_epoch: Optional[int] = None

    def on_epoch_end(self, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            return
        improved = (self._best is None or
                    (self._best - current > self.min_delta
                     if self.mode == "min"
                     else current - self._best > self.min_delta))
        if improved:
            self._best = current
            self._wait = 0
        else:
            self._wait += 1
            if self._wait > self.patience:
                self.stopped_epoch = epoch
                raise StopTraining(f"EarlyStopping at epoch {epoch}")


class LambdaCallback(Callback):
    """Epoch-end and batch-end hooks from plain functions; a batch hook
    makes the trainer read each execution's loss."""

    def __init__(self, *, on_epoch_end=None, on_batch_end=None):
        self._epoch_end = on_epoch_end
        self._batch_end = on_batch_end
        self.wants_batches = on_batch_end is not None

    def on_epoch_end(self, epoch, logs):
        if self._epoch_end:
            self._epoch_end(epoch, logs)

    def on_batch_end(self, step, logs):
        if self._batch_end:
            self._batch_end(step, logs)
