"""Training callbacks — the Keras-fit hook surface.

Counterpart of ``tpu_dist/training/callbacks.py``: the base hook protocol,
:class:`CallbackList`, :class:`History` (always installed, the object
``fit`` returns), :class:`LazyLogs` (epoch logs read from the card on
first use), :class:`StopTraining`, :class:`ModelCheckpoint`,
:class:`EarlyStopping`, :class:`JSONLogger`, :class:`TensorBoard` and
:class:`LambdaCallback`; ``Telemetry`` (``tpu_dist_torch.observe``) is
re-exported here lazily, as in the reference.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

logger = logging.getLogger("tpu_dist_torch.callbacks")


class LazyLogs(dict):
    """Epoch logs whose device scalars are read on first use.

    The trainer hands over the epoch's loss and metric results as 0-d
    tensors; they are stacked into one vector and copied to pinned host
    memory with one non-blocking copy right behind the epoch's last step,
    and an event marks its end. A value read (``[]``, ``get``, ``items``,
    ``values``, ``copy``, ``repr``) waits for that event once and turns
    every pending value into a float; key, length and membership queries
    do not wait. So a ``verbose=0`` fit with no log-reading callback never
    blocks at the epoch boundary. Until then a dict-bypassing reader (say
    ``dict(logs)``) sees the 0-d tensors. On the CPU the copy is a plain
    one.
    """

    def __init__(self, host_logs: Optional[dict] = None,
                 device_logs: Optional[dict] = None):
        super().__init__(host_logs or {})
        self._device = dict(device_logs or {})
        #: (names, host vector, event or None) of copies still in flight.
        self._copies: list = []
        if self._device:
            self._copies.append(_start_copy(self._device))
        super().update(self._device)

    def materialize(self) -> "LazyLogs":
        """Wait for the pending copies and replace every pending value with
        a plain float; idempotent."""
        if self._device:
            for names, host, event in self._copies:
                if event is not None:
                    event.synchronize()
                super().update(zip(names, host.tolist()))
            self._copies = []
            self._device = {}
        return self

    def absorb(self, other: dict, prefix: str = "") -> None:
        """Merge ``other``'s entries under ``prefix`` without waiting:
        another LazyLogs' pending values stay pending (validation logs fold
        into the epoch's so)."""
        if isinstance(other, LazyLogs):
            for names, host, event in other._copies:
                self._copies.append(
                    ([prefix + n for n in names], host, event))
            for k, v in other._device.items():
                self._device[prefix + k] = v
        for k, v in dict.items(other):
            dict.__setitem__(self, prefix + k, v)

    def __getitem__(self, key):
        self.materialize()
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.materialize()
        return super().get(key, default)

    def items(self):
        self.materialize()
        return super().items()

    def values(self):
        self.materialize()
        return super().values()

    def copy(self) -> dict:
        self.materialize()
        return dict(self)

    def __repr__(self):
        self.materialize()
        return super().__repr__()


def _start_copy(device_logs: dict) -> tuple:
    """One stacked vector of the 0-d tensors, copied to the host: to pinned
    memory without blocking (an event marks its end) on CUDA, a plain copy
    on the CPU."""
    names = list(device_logs)
    stacked = torch.stack([v.detach().reshape(()).to(torch.float64)
                           for v in device_logs.values()])
    if stacked.device.type != "cuda":
        return names, stacked, None
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return names, host, event


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
    """Per-epoch log record; ``fit`` returns this (Keras History analog).

    Epoch logs may be :class:`LazyLogs` still holding device scalars;
    History keeps them unread and folds them in, as floats, only when
    ``.history`` is read."""

    def __init__(self):
        self.epoch: list[int] = []
        self._pending: list[dict] = []
        self._history: dict[str, list] = {}

    def on_epoch_end(self, epoch, logs):
        self.epoch.append(epoch)
        self._pending.append(logs)

    @property
    def history(self) -> dict[str, list]:
        while self._pending:
            logs = self._pending.pop(0)
            if isinstance(logs, LazyLogs):
                logs.materialize()
            for k, v in logs.items():
                self._history.setdefault(k, []).append(v)
        return self._history


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
    ``on_train_end`` drains the writer. ``sharded=True`` writes the v2
    layout: each process its own blocks, no gather
    (``training/checkpoint.py``)."""

    def __init__(self, directory: str, *, save_best_only: bool = False,
                 monitor: str = "loss", mode: str = "min",
                 max_to_keep: Optional[int] = None, async_save: bool = True,
                 sharded: bool = False):
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
                self.directory, max_to_keep=self.max_to_keep,
                sharded=self.sharded)

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
                                max_to_keep=self.max_to_keep,
                                sharded=self.sharded)
        except OSError as exc:
            self._write_failed(getattr(exc, "checkpoint_step", epoch), exc)

    def publish_in_flight(self) -> None:
        """Commit the async save in flight now, without closing the writer:
        a gang reform's drain, before the survivor acks (a failed write is
        absorbed, one lost interval, as anywhere)."""
        if self._ckpt is None:
            return
        try:
            self._ckpt.wait()
        except OSError as exc:
            self._write_failed(getattr(exc, "checkpoint_step", None), exc)

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


class JSONLogger(Callback):
    """Structured per-epoch training log: one JSON line per epoch (and per
    execution with ``log_batches=True``), chief-only, appended (resumed runs
    add to the file). Keys and rounding are the reference's."""

    def __init__(self, path: str, *, log_batches: bool = False):
        self.path = path
        self._log_batches = log_batches
        self.wants_batches = False  # resolved per process at train begin
        self._file = None

    def on_train_begin(self):
        import os

        from tpu_dist_torch.cluster import bootstrap

        chief = bootstrap.is_chief()
        # Only the chief writes, so only the chief makes the trainer pay
        # the per-execution loss read that batch logging needs.
        self.wants_batches = self._log_batches and chief
        if chief:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._file = open(self.path, "a", buffering=1)

    def on_train_end(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _write(self, record: dict):
        if self._file is not None:
            import json

            self._file.write(json.dumps(record) + "\n")

    def on_epoch_end(self, epoch, logs):
        self._write({"event": "epoch", "epoch": epoch,
                     **{k: round(float(v), 6) for k, v in logs.items()}})

    def on_batch_end(self, step, logs):
        self._write({"event": "batch", "step": step,
                     **{k: round(float(v), 6) for k, v in logs.items()}})


class TensorBoard(Callback):
    """Chief-only TensorBoard scalars: each epoch's logs as ``epoch_{key}``
    through ``torch.utils.tensorboard`` where it imports; otherwise a
    warning, once, and nothing written (the reference does the same
    without TensorFlow)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None

    def on_train_begin(self):
        from tpu_dist_torch.cluster import bootstrap

        if not bootstrap.is_chief():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning(
                "TensorBoard callback: torch.utils.tensorboard is not "
                "importable; scalar event files will not be written (use "
                "JSONLogger instead)")
            return
        self._writer = SummaryWriter(self.log_dir)

    def on_epoch_end(self, epoch, logs):
        if self._writer is None:
            return
        for k, v in logs.items():
            self._writer.add_scalar(f"epoch_{k}", float(v), epoch)
        self._writer.flush()

    def on_train_end(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


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


def __getattr__(name):
    # Telemetry lives in tpu_dist_torch.observe, which imports Callback
    # from here; a lazy re-export keeps it beside the other callbacks.
    if name == "Telemetry":
        from tpu_dist_torch.observe.telemetry import Telemetry

        return Telemetry
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
