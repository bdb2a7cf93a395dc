"""Telemetry wiring: step timers, the collective observe hook, and the
``Telemetry`` fit callback.

Counterpart of ``tpu_dist/observe/telemetry.py``: the glue between the
passive :mod:`~tpu_dist_torch.observe.metrics` registry and the places
time is spent.

* :class:`StepTimer` — the trainer's loop (``training/trainer.py``) splits
  each execution into **data-wait** (the input pipeline, until the batch
  is fetched), **dispatch** (until the step or the captured graph's replay
  returns: on the card that is the host's launch work, a replay returns at
  once) and **device** (a blocking wait on the card: the current
  stream's ``synchronize``), and records per-step means here. The trainer
  finds the timer through :func:`active_step_timer`, a module global, so
  an uninstrumented loop pays one ``is None`` check per execution.
* :func:`registry_collective_hook` — plugs into the observe hook of
  ``parallel/collectives.py`` and turns every wrapper call into per-op
  counters (calls, payload bytes) and host-seconds distributions; a firing
  inside a CUDA-graph capture counts apart as a ``trace_calls``.
* :class:`Telemetry` — the fit callback that arms all of the above for one
  ``fit``, exchanges each rank's mean step time through
  ``collectives.host_all_gather`` at every epoch end (one process too: the
  exchange is what puts collective traffic in a one-process series),
  runs straggler detection on the chief, writes ``step_timing`` /
  ``straggler_detected`` records into the resilience event log and
  exports JSONL / Prometheus snapshots.

``TPU_DIST_OBSERVE_DIR=/some/dir`` makes every ``fit`` in the process
attach a :class:`Telemetry` writing ``metrics.jsonl`` and ``metrics.prom``
there (:func:`maybe_telemetry_from_env`); the Supervisor sets it per rank.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

from tpu_dist_torch.observe import exporters, straggler
from tpu_dist_torch.observe import metrics as metrics_lib
from tpu_dist_torch.training.callbacks import Callback

logger = logging.getLogger("tpu_dist_torch.observe")

#: Environment variable arming per-fit telemetry (directory for exports).
OBSERVE_DIR_ENV = "TPU_DIST_OBSERVE_DIR"

#: The StepTimer the trainer's loop reports to; None when no Telemetry
#: span is active.
_ACTIVE_TIMER: Optional["StepTimer"] = None


def active_step_timer() -> Optional["StepTimer"]:
    return _ACTIVE_TIMER


def set_active_step_timer(timer: Optional["StepTimer"]):
    """Install (or with None, clear) the loop's step timer; returns the
    previous one so callers can restore it."""
    global _ACTIVE_TIMER
    prev = _ACTIVE_TIMER
    _ACTIVE_TIMER = timer
    return prev


class StepTimer:
    """Per-execution timing split, recorded as per-step means.

    One execution covers ``steps`` train steps (1, or k under
    ``steps_per_execution``); the split is divided by ``steps`` before it is
    recorded, so the distributions are per step whatever k is. Epoch
    totals accumulate beside them for the straggler exchange.

    :meth:`record_execution` only appends to a list and adds to the epoch
    totals; :meth:`flush` (``Telemetry`` calls it at each epoch's end and at
    the fit's) records the appended executions into the registry, so the
    loop pays no lock and no reservoir update per execution.
    """

    def __init__(self, registry: Optional[metrics_lib.MetricsRegistry] = None):
        self.registry = registry or metrics_lib.get_registry()
        r = self.registry
        self._count = r.counter("step.count")
        self._total = r.distribution("step.total_s")
        self._data = r.distribution("step.data_wait_s")
        self._dispatch = r.distribution("step.dispatch_s")
        self._device = r.distribution("step.device_block_s")
        self._comm = r.distribution("step.comm_wait_s")
        self._overlap = r.distribution("step.overlap")
        self._pending: list = []
        self.reset_epoch()

    def reset_epoch(self) -> None:
        self.epoch_steps = 0
        self.epoch_total_s = 0.0
        self.epoch_data_wait_s = 0.0
        self.epoch_dispatch_s = 0.0
        self.epoch_device_s = 0.0
        self.epoch_comm_wait_s = 0.0

    def record_execution(self, *, steps: int, data_wait_s: float,
                         dispatch_s: float, device_block_s: float,
                         comm_wait_s: float = 0.0) -> None:
        if steps <= 0:
            return
        total = data_wait_s + dispatch_s + device_block_s
        self._pending.append((steps, total, data_wait_s, dispatch_s,
                              device_block_s, comm_wait_s))
        self.epoch_steps += steps
        self.epoch_total_s += total
        self.epoch_data_wait_s += data_wait_s
        self.epoch_dispatch_s += dispatch_s
        self.epoch_device_s += device_block_s
        self.epoch_comm_wait_s += comm_wait_s

    def flush(self) -> None:
        """Record the executions appended since the last flush into the
        registry, each as per-step means."""
        pending, self._pending = self._pending, []
        for steps, total, data, dispatch, device, comm in pending:
            per = 1.0 / steps
            self._count.inc(steps)
            self._total.observe(total * per)
            self._data.observe(data * per)
            self._dispatch.observe(dispatch * per)
            self._device.observe(device * per)
            self._comm.observe(comm * per)
            if total > 0:
                self._overlap.observe(device / total)

    def epoch_mean_step_s(self) -> float:
        if self.epoch_steps == 0:
            return 0.0
        return self.epoch_total_s / self.epoch_steps


def registry_collective_hook(
        registry: Optional[metrics_lib.MetricsRegistry] = None):
    """A collective observe hook that records per-op calls, payload bytes
    and host seconds into a registry. Firings inside a CUDA-graph capture
    (``phase="trace"``) also count as ``trace_calls``, so a reader never
    takes recording for steady-state traffic."""
    r = registry or metrics_lib.get_registry()

    def hook(op: str, *, phase: str, leaves: int, nbytes: int,
             seconds: Optional[float] = None) -> None:
        r.counter(f"collective.{op}.calls").inc()
        if phase == "trace":
            r.counter(f"collective.{op}.trace_calls").inc()
        if nbytes:
            r.counter(f"collective.{op}.bytes").inc(nbytes)
        if seconds is not None:
            r.distribution(f"collective.{op}.host_seconds").observe(seconds)
            if phase != "trace":
                r.distribution("step.comm_wait_s").observe(seconds)

    return hook


class Telemetry(Callback):
    """Arm metrics, collective telemetry and straggler detection for one
    fit. ``on_train_begin`` resets and enables the registry, installs the
    collective observe hook and the loop's step timer; ``on_train_end``
    restores every previous state, so sequential fits compose. Without
    paths the callback only fills the registry (and the event log, if
    armed). The exports run at each epoch's end and at the fit's."""

    def __init__(self, *,
                 jsonl_path: Optional[str | os.PathLike] = None,
                 prometheus_path: Optional[str | os.PathLike] = None,
                 registry: Optional[metrics_lib.MetricsRegistry] = None,
                 straggler_threshold: float = straggler.DEFAULT_THRESHOLD):
        self.registry = registry or metrics_lib.get_registry()
        self.jsonl_path = jsonl_path
        self.prometheus_path = prometheus_path
        self.straggler_threshold = straggler_threshold
        self.timer: Optional[StepTimer] = None
        self._exporter: Optional[exporters.JsonlExporter] = None
        self._prev_hook = None
        self._prev_timer = None
        self._was_enabled = False
        self._armed = False

    def on_train_begin(self) -> None:
        from tpu_dist_torch.parallel import collectives

        self._was_enabled = self.registry.enabled
        self.registry.reset()
        self.registry.enable()
        self._prev_hook = collectives.install_observe_hook(
            registry_collective_hook(self.registry))
        self.timer = StepTimer(self.registry)
        self._prev_timer = set_active_step_timer(self.timer)
        if self.jsonl_path is not None:
            self._exporter = exporters.JsonlExporter(self.jsonl_path)
        self._armed = True

    def on_train_end(self) -> None:
        if not self._armed:
            return
        from tpu_dist_torch.parallel import collectives

        if self.timer is not None:
            self.timer.flush()
        self._export(kind="final", epoch=None)
        collectives.install_observe_hook(self._prev_hook)
        set_active_step_timer(self._prev_timer)
        if not self._was_enabled:
            self.registry.disable()
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        self._armed = False

    def on_epoch_begin(self, epoch: int) -> None:
        if self.timer is not None:
            self.timer.reset_epoch()

    def on_epoch_end(self, epoch: int, logs: dict) -> None:
        if not self._armed:
            return
        import numpy as np

        from tpu_dist_torch.cluster import bootstrap
        from tpu_dist_torch.parallel import collectives
        from tpu_dist_torch.resilience import events

        r = self.registry
        timer = self.timer
        if timer is not None:
            timer.flush()
        epoch_time = float(logs.get("epoch_time", 0.0) or 0.0)
        if "loss" in logs:
            r.gauge("epoch.last_loss").set(float(logs["loss"]))
        r.gauge("epoch.last_time_s").set(epoch_time)
        steps = timer.epoch_steps if timer is not None else 0
        if steps and epoch_time > 0:
            r.gauge("epoch.steps_per_s").set(steps / epoch_time)
        mean_step = timer.epoch_mean_step_s() if timer is not None else 0.0

        # Every rank's mean step time, through the instrumented host
        # collective: one process records collective traffic too.
        per_rank = collectives.host_all_gather(np.float32(mean_step))
        per_rank = [float(t) for t in np.asarray(per_rank).reshape(-1)]
        for rank_i, t in enumerate(per_rank):
            r.gauge(f"rank{rank_i}.step_time_s").set(t)

        events.maybe_log(
            "step_timing", rank=bootstrap.process_index(), epoch=epoch,
            steps=steps, mean_step_s=round(mean_step, 6),
            data_wait_s=round(timer.epoch_data_wait_s, 6) if timer else 0.0,
            dispatch_s=round(timer.epoch_dispatch_s, 6) if timer else 0.0,
            device_s=round(timer.epoch_device_s, 6) if timer else 0.0,
            comm_wait_s=round(timer.epoch_comm_wait_s, 6) if timer else 0.0)

        if bootstrap.is_chief():
            for verdict in straggler.detect_stragglers(
                    per_rank, threshold=self.straggler_threshold):
                r.counter("straggler.flags").inc()
                logger.warning(
                    "straggler: rank %d at %.4fs/step, %.1fx the gang "
                    "median", verdict.rank, verdict.step_s, verdict.ratio)
                events.maybe_log("straggler_detected", epoch=epoch,
                                 **verdict.to_dict())
        self._export(kind="epoch", epoch=epoch)

    def _export(self, *, kind: str, epoch: Optional[int]) -> None:
        snapshot = self.registry.snapshot()
        stamp = {"kind": kind}
        if epoch is not None:
            stamp["epoch"] = epoch
        try:
            if self._exporter is not None:
                self._exporter.write(snapshot, **stamp)
            if self.prometheus_path is not None:
                exporters.write_prometheus_textfile(
                    snapshot, self.prometheus_path)
        except OSError as exc:  # diagnostics must never kill the run
            logger.warning("telemetry export failed: %s", exc)


def maybe_telemetry_from_env() -> Optional[Telemetry]:
    """A :class:`Telemetry` writing under ``$TPU_DIST_OBSERVE_DIR``, or None
    when the variable is unset: ``fit`` calls this, so a Supervisor (or a
    shell) instruments any run without code edits."""
    d = os.environ.get(OBSERVE_DIR_ENV)
    if not d:
        return None
    base = Path(d)
    return Telemetry(jsonl_path=base / "metrics.jsonl",
                     prometheus_path=base / "metrics.prom")
