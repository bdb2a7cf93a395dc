"""Fault injectors: the training ``FaultInjector`` callback, the preemption
drain, the epoch rejoin gate, and the serve engine's injector.

Counterpart of ``tpu_dist/resilience/injector.py``. The training injector
is a :class:`~tpu_dist_torch.training.callbacks.Callback` plus seams it
installs for what a callback cannot reach:

* ``parallel/collectives.install_fault_hook`` for ``delay_collective`` /
  ``hang_collective``: host-level collectives (barriers, broadcasts, host
  reductions) stall as if the fabric did;
* ``training/checkpoint.install_write_fault_hook`` for ``checkpoint_fail``
  (a staged write raises, ``transient``, or is cut short in place,
  ``truncate``) and ``kill_during_save`` (``os._exit`` with the step staged
  and unpublished; on the async writer's thread under async saves);
* ``training/integrity.install_batch_fault_hook`` for ``nan_loss``,
  ``grad_spike`` and ``corrupt_batch``: the target step's batch is
  poisoned right before it runs. ``bitflip`` rides ``on_batch_end``: it
  flips one bit of one parameter in one process
  (``integrity.flip_param_bit``), which only the SDC audit can see.

Step accounting is the JAX package's: ``on_batch_end`` fires once per
execution with its last in-epoch step, the injector tracks the global step
``epoch * steps_per_epoch + step`` (stable across resume), and
``FaultSpec.due_at_step`` uses ``>=``, so k > 1 cannot jump past a
target. Kills are ``os._exit(exit_code)``: no cleanup, no atexit.

Differences from the JAX package, each because a replica is a process
here (one device each):

* ``bitflip@stepN:leafK:replicaR`` arms in the process of rank R (the
  fault's ``:rankN`` without ``:replicaR``), where the JAX package arms
  it in every process of a one-process run and flips device R there. A
  one-process run has no replica to compare, so the chaos CLI runs
  bitflip over ``--workers >= 2``.
* Token batches (integer ``x``): the labels are set to ``2**30``, far
  outside any vocabulary, as in the JAX package, where the label gather's
  fill turns them into a NaN loss; the port's plain cross-entropy does the
  same (``ops/losses.py``), while the fused one (the TPU kernel's rule,
  rows 1-2) reads such a row's loss as its log-sum-exp, so a fused-CE
  model absorbs the fault in both packages. ``grad_spike`` and
  ``corrupt_batch`` also garble x: the JAX package multiplies the ids by
  -7 and its embedding gather clamps them into range, where PyTorch's
  would index out of bounds; the port reverses each row's token order
  instead, which stays in range.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Optional, Sequence

import torch

from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience import faults as faults_mod
from tpu_dist_torch.resilience.faults import FaultPlan, FaultSpec, HANG_SECONDS
from tpu_dist_torch.training.callbacks import Callback, StopTraining

logger = logging.getLogger("tpu_dist_torch.resilience")

_COLLECTIVE_KINDS = ("delay_collective", "hang_collective")
_WRITE_KINDS = ("checkpoint_fail", "kill_during_save")
#: A poisoned token batch's labels: outside any vocabulary.
_BAD_LABEL = 2 ** 30
_SCALES = {"nan_loss": float("nan"), "grad_spike": 1e6,
           "corrupt_batch": -1e7}


def integrity_mod():
    """Lazy import of ``training/integrity.py`` (it imports the trainer's
    layer; plan parsing does not need it)."""
    from tpu_dist_torch.training import integrity

    return integrity


def _poison(kind: str, step: int, first_gstep: int, k: int, x, y):
    """The batch of a due semantic fault (module docstring): in a stacked
    k-step window only the target step's slice. Numpy in, numpy out."""
    numpy_in = not isinstance(x, torch.Tensor)
    tx, ty = torch.as_tensor(x).clone(), torch.as_tensor(y).clone()
    s = step - first_gstep
    part = (lambda t: t[s]) if k > 1 and s < tx.shape[0] else (lambda t: t)
    if tx.is_floating_point():
        part(tx).mul_(_SCALES[kind])
    else:
        part(ty).fill_(_BAD_LABEL)
        if kind != "nan_loss":
            part(tx).copy_(part(tx).flip(-1))
    if numpy_in:
        return tx.numpy(), ty.numpy()
    return tx, ty


class FaultInjector(Callback):
    """Arms a process's slice of a FaultPlan for one ``fit``."""

    wants_batches = True  # global-step tracking needs per-execution hooks

    def __init__(self, faults: Sequence[FaultSpec], *, steps_per_epoch: int,
                 event_log: Optional[events.EventLog] = None):
        self.faults = list(faults)
        self.steps_per_epoch = int(steps_per_epoch)
        self._events = event_log
        #: Remaining firings per fault (specs are frozen; state lives here).
        self._remaining = [f.count for f in self.faults]
        self._epoch = 0
        self._global_step = 0
        self._prev_collective_hook = None
        self._prev_write_hook = None
        self._prev_batch_hook = None
        self._installed = False

    def _log(self, event: str, **fields) -> None:
        try:
            log = self._events or events.log_from_env()
            if log is not None:
                log.append(event, attempt=events.current_attempt(), **fields)
        except OSError:  # observability must never fail the run
            pass

    def _has(self, kinds) -> bool:
        return any(f.kind in kinds for f in self.faults)

    # -- seam installation ---------------------------------------------------

    def on_train_begin(self) -> None:
        from tpu_dist_torch.parallel import collectives
        from tpu_dist_torch.training import checkpoint

        if self._has(_COLLECTIVE_KINDS):
            self._prev_collective_hook = collectives.install_fault_hook(
                self._collective_hook)
        if self._has(_WRITE_KINDS):
            self._prev_write_hook = checkpoint.install_write_fault_hook(
                self._write_hook)
        if self._has(integrity_mod().BATCH_FAULT_KINDS):
            self._prev_batch_hook = integrity_mod().install_batch_fault_hook(
                self._batch_hook)
        self._installed = True
        for f in self.faults:
            self._log("fault_armed", kind=f.kind, step=f.step, epoch=f.epoch,
                      rank=f.rank)
        if events.current_attempt() > 0:
            self._log("resumed")

    def on_train_end(self) -> None:
        if not self._installed:
            return
        self._installed = False
        from tpu_dist_torch.parallel import collectives
        from tpu_dist_torch.training import checkpoint

        if self._has(_COLLECTIVE_KINDS):
            collectives.install_fault_hook(self._prev_collective_hook)
        if self._has(_WRITE_KINDS):
            checkpoint.install_write_fault_hook(self._prev_write_hook)
        if self._has(integrity_mod().BATCH_FAULT_KINDS):
            integrity_mod().install_batch_fault_hook(self._prev_batch_hook)

    # -- firing --------------------------------------------------------------

    def on_epoch_begin(self, epoch: int) -> None:
        self._epoch = epoch
        self._global_step = epoch * self.steps_per_epoch
        for i, f in enumerate(self.faults):
            if (f.kind in ("kill", "preempt") and self._remaining[i] > 0
                    and f.step is None and f.due_at_epoch(epoch)):
                if f.kind == "kill":
                    self._fire_kill(i, f, at=f"epoch {epoch}")
                else:
                    self._fire_preempt(i, f, at=f"epoch {epoch}")

    def on_batch_end(self, step: int, logs: dict) -> None:
        gstep = self._epoch * self.steps_per_epoch + step
        self._global_step = gstep
        for i, f in enumerate(self.faults):
            if (self._remaining[i] <= 0 or f.step is None
                    or not f.due_at_step(gstep)):
                continue
            if f.kind == "kill":
                self._fire_kill(i, f, at=f"step {gstep}")
            elif f.kind == "job_kill":
                self._fire_kill(i, f, at=f"job {f.job} step {gstep}",
                                kind="job_kill")
            elif f.kind == "job_hang":
                self._remaining[i] -= 1
                self._log("fault_fired", kind="job_hang", job=f.job,
                          step=gstep, seconds=f.seconds)
                logger.warning("fault injection: hanging job %s worker "
                               "%.1fs at step %d", f.job, f.seconds, gstep)
                time.sleep(f.seconds)
            elif f.kind == "preempt":
                self._fire_preempt(i, f, at=f"step {gstep}")
            elif f.kind == "slow_input":
                self._remaining[i] -= 1
                self._log("fault_fired", kind=f.kind, step=gstep,
                          seconds=f.seconds)
                time.sleep(f.seconds)
            elif f.kind == "bitflip":
                self._fire_bitflip(i, f, gstep)

    def _fire_bitflip(self, i: int, f: FaultSpec, gstep: int) -> None:
        """Silent data corruption: one bit of this process's copy of leaf
        ``:leafK`` (default 0). Nothing in the step notices; the flipped
        value is read by the next execution, and only the SDC audit's
        shard-group compare can see it."""
        self._remaining[i] -= 1
        trainer = getattr(self.model, "_trainer", None)
        if trainer is None or trainer.variables is None:
            self._log("fault_skipped", kind="bitflip", step=gstep,
                      reason="no live trainer variables")
            return
        info = integrity_mod().flip_param_bit(
            self.model, replica=f.rank if f.replica is None else f.replica,
            leaf=0 if f.leaf is None else f.leaf)
        self._log("fault_fired", kind="bitflip", step=gstep, **info)
        logger.warning("fault injection: flipped bit %d (effective %d) of %s "
                       "on replica %d at step %d", info["bit"],
                       info["effective_bit"], info["leaf"], info["replica"],
                       gstep)

    def _fire_kill(self, i: int, f: FaultSpec, *, at: str,
                   kind: str = "kill") -> None:
        self._remaining[i] -= 1
        self._log("fault_fired", kind=kind, at=at, exit_code=f.exit_code)
        logger.warning("fault injection: killing process at %s (exit %d)",
                       at, f.exit_code)
        os._exit(f.exit_code)

    def _fire_preempt(self, i: int, f: FaultSpec, *, at: str) -> None:
        """A real SIGTERM to this process: the SIGTERM seam
        (``entrypoints.install_sigterm_handler``) records it and the
        :class:`PreemptionDrain` callback stops training at this step
        boundary. Without the seam SIGTERM's default action kills the
        process (an ungraceful worker)."""
        from tpu_dist_torch.resilience import entrypoints

        self._remaining[i] -= 1
        self._log("fault_fired", kind="preempt", at=at)
        logger.warning("fault injection: delivering SIGTERM to self at %s",
                       at)
        os.kill(os.getpid(), signal.SIGTERM)
        # The handler runs on this (main) thread at the next bytecode
        # boundary; yield until it has, so the drain later in this same
        # callback round sees the request.
        if entrypoints.preemption_armed():
            deadline = time.monotonic() + 5.0
            while (not entrypoints.preemption_requested()
                   and time.monotonic() < deadline):
                time.sleep(0.001)

    # -- seam hooks ----------------------------------------------------------

    def _collective_hook(self, op: str) -> None:
        for i, f in enumerate(self.faults):
            if f.kind not in _COLLECTIVE_KINDS or self._remaining[i] <= 0:
                continue
            due = (f.due_at_step(self._global_step) if f.step is not None
                   else f.due_at_epoch(self._epoch))
            if not due:
                continue
            self._remaining[i] -= 1
            seconds = (HANG_SECONDS if f.kind == "hang_collective"
                       else f.seconds)
            self._log("fault_fired", kind=f.kind, op=op, seconds=seconds)
            logger.warning("fault injection: stalling collective %r for "
                           "%.1fs", op, seconds)
            time.sleep(seconds)
        if self._prev_collective_hook is not None:
            self._prev_collective_hook(op)

    def _write_hook(self, stage_dir, step: int) -> None:
        # ``step`` is the checkpoint's step (the epoch for ModelCheckpoint's
        # saves), matched against the fault's epoch when it has one.
        for i, f in enumerate(self.faults):
            if f.kind not in _WRITE_KINDS or self._remaining[i] <= 0:
                continue
            due = (f.due_at_epoch(step) if f.epoch is not None
                   else f.due_at_step(step))
            if not due:
                continue
            self._remaining[i] -= 1
            if f.kind == "kill_during_save":
                self._log("fault_fired", kind="kill_during_save", step=step,
                          exit_code=f.exit_code)
                logger.warning(
                    "fault injection: killing process during checkpoint "
                    "save of step %d (stage %s unpublished, exit %d)",
                    step, stage_dir, f.exit_code)
                os._exit(f.exit_code)
            self._log("fault_fired", kind="checkpoint_fail", mode=f.mode,
                      step=step)
            if f.mode == "transient":
                raise OSError(f"injected transient checkpoint write failure "
                              f"at step {step}")
            _truncate_stage(stage_dir)
        if self._prev_write_hook is not None:
            self._prev_write_hook(stage_dir, step)

    def _batch_hook(self, first_gstep: int, k: int, x, y):
        """Poison the batch of a due semantic fault: when the window
        ``[first_gstep, first_gstep + k)`` reaches the fault's step. The
        count is consumed, so the replay after the rollback trains on the
        clean batch: that is what makes exact loss parity possible."""
        for i, f in enumerate(self.faults):
            if (f.kind not in integrity_mod().BATCH_FAULT_KINDS
                    or self._remaining[i] <= 0 or f.step is None
                    or f.step >= first_gstep + k):
                continue
            self._remaining[i] -= 1
            self._log("fault_fired", kind=f.kind, step=f.step,
                      window_start=first_gstep, window=k)
            logger.warning("fault injection: %s poisoning batch window "
                           "[%d, %d)", f.kind, first_gstep, first_gstep + k)
            x, y = _poison(f.kind, f.step, first_gstep, k, x, y)
        if self._prev_batch_hook is not None:
            return self._prev_batch_hook(first_gstep, k, x, y)
        return x, y


def _truncate_stage(stage_dir) -> None:
    """Cut every staged .npz in half: the footprint of a writer that died
    mid-write on a filesystem whose publish was not atomic. The zip's
    central directory is at its end, so the file no longer opens and
    validation rejects the step."""
    import pathlib

    for npz in sorted(pathlib.Path(stage_dir).glob("*.npz")):
        size = npz.stat().st_size
        with open(npz, "r+b") as fh:
            fh.truncate(max(1, size // 2))
        logger.warning("fault injection: truncated %s to %d bytes",
                       npz, max(1, size // 2))


def _bitflip_target(f: FaultSpec) -> int:
    """The rank whose copy a bitflip corrupts: ``:replicaR``, else the
    fault's rank."""
    return f.rank if f.replica is None else f.replica


def maybe_injector_from_env(*, steps_per_epoch: int,
                            rank: Optional[int] = None,
                            attempt: Optional[int] = None
                            ) -> Optional[FaultInjector]:
    """The injector of this process's slice of ``$TPU_DIST_FAULT_PLAN``,
    or None when no plan is set or no fault targets (rank, attempt)."""
    from tpu_dist_torch.cluster import bootstrap

    plan = FaultPlan.from_env()
    if not plan:
        return None
    if rank is None:
        env_rank = os.environ.get("TPU_DIST_REJOIN_RANK")
        if env_rank is not None and bootstrap.process_count() == 1:
            # Supervised single-process workers all are process 0; their
            # gang rank comes through the environment.
            rank = int(env_rank)
        else:
            rank = bootstrap.process_index()
    if attempt is None:
        attempt = events.current_attempt()
        # A worker relaunched into a live attempt folds its incarnation
        # in, so an attempt-0 one-shot fault does not fire again in it.
        try:
            attempt += int(os.environ.get("TPU_DIST_GANG_REJOIN", "0") or 0)
        except ValueError:
            pass
    mine = [f for f in plan.faults
            if (f.attempt is None or attempt == f.attempt)
            and (_bitflip_target(f) if f.kind == "bitflip" else f.rank)
            == rank]
    # Faults with a @jobN coordinate arm only in that packed job's gang.
    job_index = faults_mod.current_job_index()
    mine = [f for f in mine if f.matches_job(job_index)]
    if not mine:
        return None
    logger.info("fault plan armed for rank %d attempt %d: %d fault(s)",
                rank, attempt, len(mine))
    return FaultInjector(mine, steps_per_epoch=steps_per_epoch)


class PreemptionDrain(Callback):
    """Stops training at the first step boundary after a SIGTERM (in a
    process group, after a SIGTERM to any rank: :func:`_gang_agrees`).

    The signal handler (``entrypoints.install_sigterm_handler``) only
    records the notice; this callback raises :class:`StopTraining` at the
    next step (or epoch) boundary, which ``fit`` catches; its ``finally``
    closes ``ModelCheckpoint``, which joins and publishes any save in
    flight, and the worker exits ``EXIT_PREEMPTED``. It writes no
    checkpoint of the partial epoch: resume is epoch-granular, so the
    interrupted epoch is replayed from its start instead, which keeps the
    chaos gate's exact loss parity."""

    wants_batches = True

    def on_batch_end(self, step: int, logs: dict) -> None:
        self._maybe_stop(f"step boundary (in-epoch step {step})")

    def on_epoch_begin(self, epoch: int) -> None:
        self._maybe_stop(f"epoch {epoch} boundary")

    @staticmethod
    def _maybe_stop(where: str) -> None:
        from tpu_dist_torch.resilience import entrypoints

        mine = entrypoints.preemption_requested()
        if _gang_agrees(mine):
            if not mine:
                entrypoints.request_preemption("a peer was preempted")
            logger.warning("preemption drain: stopping training at %s",
                           where)
            raise StopTraining(f"preempted (drained at {where})")


def _gang_agrees(flag: bool) -> bool:
    """``flag`` on any process of the process group (the flag itself with
    none): every rank of a gang stops at the same step boundary, so the
    collectives of the drain that follows (the commit of a save in
    flight) meet, where a lone rank's would meet its peers' next step."""
    from tpu_dist_torch.cluster import bootstrap

    if bootstrap.process_count() == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=bootstrap.device_of_group())
    dist.all_reduce(t)
    return bool(t.item())


def maybe_preemption_drain() -> Optional[PreemptionDrain]:
    """A :class:`PreemptionDrain` when the SIGTERM seam is armed (the
    process runs under ``run_entry``), else None."""
    from tpu_dist_torch.resilience import entrypoints

    if not entrypoints.preemption_armed():
        return None
    return PreemptionDrain()


class RejoinGate(Callback):
    """Epoch-boundary rendezvous: holds every worker at ``on_epoch_begin``
    until the whole gang has arrived, so a recovered worker re-enters at
    the next epoch boundary instead of forcing a gang restart. The barrier
    is ``bootstrap.epoch_rendezvous`` on a shared directory, not a
    collective: the rejoining worker is a fresh process outside any group.
    Records ``elastic.rejoin_wait_s`` and a ``rejoin_rendezvous`` event."""

    def __init__(self, directory: str, *, world: Optional[int] = None,
                 rank: Optional[int] = None, timeout_s: float = 120.0):
        self.directory = directory
        self.world = world
        self.rank = rank
        self.timeout_s = float(timeout_s)

    def on_epoch_begin(self, epoch: int) -> None:
        from tpu_dist_torch.cluster import bootstrap
        from tpu_dist_torch.observe import metrics as metrics_lib

        t0 = time.monotonic()
        ranks = bootstrap.epoch_rendezvous(
            self.directory, epoch=epoch, rank=self.rank, world=self.world,
            timeout_s=self.timeout_s)
        wait_s = time.monotonic() - t0
        metrics_lib.observe_value("elastic.rejoin_wait_s", wait_s)
        log = events.log_from_env()
        if log is not None:
            log.append("rejoin_rendezvous", attempt=events.current_attempt(),
                       epoch=epoch, ranks=ranks, wait_s=round(wait_s, 6))


def maybe_rejoin_gate() -> Optional[RejoinGate]:
    """A :class:`RejoinGate` when ``$TPU_DIST_REJOIN_DIR`` names the
    rendezvous directory, else None. ``$TPU_DIST_REJOIN_WORLD`` /
    ``$TPU_DIST_REJOIN_RANK`` override the gang coordinates (supervised
    single-process workers each are process 0 of their own);
    ``$TPU_DIST_REJOIN_TIMEOUT_S`` bounds the wait (default 120)."""
    from tpu_dist_torch.cluster import bootstrap

    directory = os.environ.get(bootstrap.REJOIN_DIR_ENV)
    if not directory:
        return None
    world = os.environ.get("TPU_DIST_REJOIN_WORLD")
    rank = os.environ.get("TPU_DIST_REJOIN_RANK")
    timeout_s = float(os.environ.get("TPU_DIST_REJOIN_TIMEOUT_S", "120"))
    return RejoinGate(directory, world=int(world) if world else None,
                      rank=int(rank) if rank else None, timeout_s=timeout_s)


class ServeFaultInjector:
    """Executes the SERVE slice of a FaultPlan from inside the engine loop.

    Not a training callback — the :class:`~tpu_dist_torch.serve.engine.
    ServeEngine` calls the two seams directly each decode round:

    * ``on_decode()`` — between the decode dispatch and the host read of
      its logits, inside the engine's stall-watchdog window: a due
      ``decode_stall`` sleeps there, indistinguishable from a hung device
      call, so the watchdog (not the injector) ends the process.
    * ``on_step_end(done_count)`` — after retirements but BEFORE the
      journal flush: a due ``engine_crash@reqN`` (fires once
      ``done_count`` reaches N completed requests) is ``os._exit`` with
      the journal's unflushed tail lost, the harsher recovery case for the
      parity gate.

    ``request_storm`` is a submission-side fault: the chaos runner
    (``serve/chaos.py``) interprets it, not this injector.
    """

    ENGINE_KINDS = ("engine_crash", "decode_stall")

    def __init__(self, faults: Sequence[FaultSpec],
                 event_log: Optional[events.EventLog] = None):
        self.faults = [f for f in faults if f.kind in self.ENGINE_KINDS]
        self._events = event_log
        self._remaining = [f.count for f in self.faults]
        self._done = 0

    def _log(self, event: str, **fields) -> None:
        try:
            log = self._events or events.log_from_env()
            if log is not None:
                log.append(event, attempt=events.current_attempt(), **fields)
        except OSError:
            pass

    def arm(self) -> "ServeFaultInjector":
        for f in self.faults:
            self._log("fault_armed", kind=f.kind, req=f.req)
        if events.current_attempt() > 0:
            self._log("resumed")
        return self

    def on_decode(self) -> None:
        for i, f in enumerate(self.faults):
            if (f.kind != "decode_stall" or self._remaining[i] <= 0
                    or not f.due_at_req(self._done)):
                continue
            self._remaining[i] -= 1
            self._log("fault_fired", kind="decode_stall", req=f.req,
                      seconds=f.seconds)
            logger.warning("fault injection: stalling decode step for "
                           "%.1fs (after %d completed)", f.seconds,
                           self._done)
            time.sleep(f.seconds)

    def on_step_end(self, done_count: int) -> None:
        self._done = int(done_count)
        for i, f in enumerate(self.faults):
            if (f.kind != "engine_crash" or self._remaining[i] <= 0
                    or not f.due_at_req(done_count)):
                continue
            self._remaining[i] -= 1
            self._log("fault_fired", kind="engine_crash", req=f.req,
                      done=done_count, exit_code=f.exit_code)
            logger.warning("fault injection: killing serve engine after "
                           "%d completed requests (exit %d)", done_count,
                           f.exit_code)
            os._exit(f.exit_code)


def maybe_serve_injector_from_env(*, attempt: Optional[int] = None
                                  ) -> Optional[ServeFaultInjector]:
    """This serve process's injector from ``$TPU_DIST_FAULT_PLAN``, or None
    when no plan is set or no engine-side serve fault targets this attempt
    (serve workers are single-process: rank 0)."""
    plan = FaultPlan.from_env()
    if not plan:
        return None
    if attempt is None:
        attempt = events.current_attempt()
    mine = [f for f in plan.for_process(0, attempt)
            if f.kind in ServeFaultInjector.ENGINE_KINDS]
    if not mine:
        return None
    logger.info("serve fault plan armed for attempt %d: %d fault(s)",
                attempt, len(mine))
    return ServeFaultInjector(mine).arm()
