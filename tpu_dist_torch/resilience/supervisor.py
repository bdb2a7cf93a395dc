"""Supervisor: launch, watch, restart.

Counterpart of ``tpu_dist/resilience/supervisor.py``: a parent process that

* launches the job as ``num_workers`` subprocesses (with ``num_workers >
  1`` each rank gets its TF_CONFIG from ``cluster.make_local_cluster`` on
  fresh loopback ports every attempt: rank 0 hosted the rendezvous and
  took it down with itself);
* watches exit codes and classifies them against the resilience protocol
  (:func:`~tpu_dist_torch.resilience.faults.classify_exit_code`);
* gang-restarts on failure — synchronous data parallelism cannot run a
  partial cluster, so when one rank dies the rest get the
  :class:`GracePolicy` (exit grace, then SIGTERM, then SIGKILL) and the
  whole gang relaunches — with exponential backoff, a restart budget,
  ``no_restart_exits`` and a per-attempt wall-clock deadline that turns a
  hang into a restart;
* is elastic, as the reference: ``worker_schedule`` reshapes the gang
  across attempts (entry ``a`` is attempt ``a``'s process count, the last
  repeats); ``rejoin_window_s > 0`` relaunches a lost non-chief rank into
  the same attempt (it rejoins at the next epoch rendezvous);
  ``step_rejoin_dir`` runs the mid-epoch gang reform
  (:meth:`Supervisor._begin_reform`: request, acks, consensus restore
  step, new generation, replacement), falling back to a gang restart on an
  ack timeout or a second loss.

Worker stdout/stderr stream to per-(attempt, rank) log files (a
replacement's with ``-rejoin{k}``; a PIPE would deadlock once a killed
worker stops draining it), and every lifecycle event lands in the shared
:mod:`~tpu_dist_torch.resilience.events` JSONL log. ``observe_dir`` arms
each worker's telemetry, as in the reference (:class:`Supervisor`).

One device a process (ROADMAP item 12b): ``device_schedule``, the
reference's per-worker device counts, takes only ones; more raises
``unported``. A reshape is a change of process count here.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import subprocess
import time
from typing import Optional, Sequence

from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (EXIT_INTEGRITY, EXIT_PREEMPTED,
                                              classify_exit_code)
from tpu_dist_torch.utils.errors import unported

logger = logging.getLogger("tpu_dist_torch.resilience")

#: How long a surviving rank gets to exit on its own after a gang member
#: died, before the supervisor escalates (see :class:`GracePolicy`).
GANG_GRACE_S = 5.0

_POLL_S = 0.1


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential restart backoff: ``min(max_s, initial_s * multiplier**n)``
    before restart attempt ``n`` (0-based over *restarts*, so the first
    restart waits ``initial_s``)."""

    initial_s: float = 0.5
    multiplier: float = 2.0
    max_s: float = 30.0

    def delay(self, restart: int) -> float:
        if restart < 0:
            raise ValueError(f"restart index must be >= 0, got {restart}")
        return min(self.max_s, self.initial_s * self.multiplier ** restart)


@dataclasses.dataclass(frozen=True)
class GracePolicy:
    """How a condemned gang is taken down: wait ``exit_grace_s`` for the
    survivors to exit on their own, then SIGTERM, wait ``term_grace_s``,
    then SIGKILL. A deadline-hit (hung) attempt goes straight to SIGKILL:
    its main thread is wedged and could not answer SIGTERM."""

    exit_grace_s: float = GANG_GRACE_S
    term_grace_s: float = 10.0


@dataclasses.dataclass
class AttemptOutcome:
    attempt: int
    exit_codes: list
    duration_s: float
    deadline_hit: bool = False
    #: Gang shape this attempt ran at (elastic schedules vary these).
    num_workers: Optional[int] = None
    device_count: Optional[int] = None
    #: Per-rank relaunches absorbed without a gang restart.
    rejoins: int = 0
    #: Longest SIGTERM-to-drained duration any rank of this attempt
    #: reported (``preempt_drained`` events); None when nothing drained.
    drain_s: Optional[float] = None
    #: Mid-epoch gang reforms absorbed within this attempt.
    gang_reforms: int = 0
    #: ``time.monotonic()`` when this attempt's first worker death was
    #: detected: the zero point of ``recovery_wall_s``.
    first_failure_t: Optional[float] = None

    @property
    def succeeded(self) -> bool:
        return (not self.deadline_hit
                and all(c == 0 for c in self.exit_codes))

    @property
    def preempted(self) -> bool:
        """True when every nonzero exit was a clean SIGTERM drain."""
        nonzero = [c for c in self.exit_codes if c != 0]
        return bool(nonzero) and all(c == EXIT_PREEMPTED for c in nonzero)


@dataclasses.dataclass
class SupervisorReport:
    success: bool
    attempts: int
    restarts: int
    outcomes: list
    wall_time_s: float
    #: Wall-clock from the first detected failure to final success; None
    #: when nothing failed.
    recovery_wall_s: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "success": self.success,
            "attempts": self.attempts,
            "restarts": self.restarts,
            "wall_time_s": round(self.wall_time_s, 3),
            "recovery_wall_s": (None if self.recovery_wall_s is None
                                else round(self.recovery_wall_s, 3)),
            "exit_codes": [o.exit_codes for o in self.outcomes],
            "exit_kinds": [[classify_exit(c) for c in o.exit_codes]
                           for o in self.outcomes],
            "gang_shapes": [{"num_workers": o.num_workers,
                             "device_count": o.device_count}
                            for o in self.outcomes],
            "rejoins": [o.rejoins for o in self.outcomes],
            "drain_s": [None if o.drain_s is None else round(o.drain_s, 3)
                        for o in self.outcomes],
            "gang_reforms": [o.gang_reforms for o in self.outcomes],
        }


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def classify_exit(code: Optional[int]) -> str:
    """Name a worker's exit for reports: the protocol registry of
    :mod:`~tpu_dist_torch.resilience.faults`, plus the process-never-
    exited case (None)."""
    if code is None:
        return "crash"
    return classify_exit_code(code)


class Supervisor:
    """Run ``cmd`` as a supervised (optionally multi-worker) job.

    ``cmd`` is the worker argv; every worker of every attempt runs the
    same argv and is told apart through the environment: a per-rank
    ``TF_CONFIG`` and ``TPU_DIST_REJOIN_RANK`` / ``_WORLD`` (only when the
    attempt has more than one worker), ``TPU_DIST_RESILIENCE_ATTEMPT``,
    the gang directory and generation under ``step_rejoin_dir``, and
    whatever the caller passes in ``env``. ``rank_scoped_env_keys`` names
    env vars whose values get a ``/rank{r}`` suffix per worker (a
    checkpoint directory, say).

    ``observe_dir`` arms per-worker telemetry: each rank gets
    ``TPU_DIST_OBSERVE_DIR=<observe_dir>/rank<r>``, so its ``fit``
    attaches a :class:`~tpu_dist_torch.observe.telemetry.Telemetry`
    callback whose ``step_timing`` / ``straggler_detected`` records land
    in the shared event log (exports append across restarts: one series
    per rank).
    """

    def __init__(self, cmd: Sequence[str], *, num_workers: int = 1,
                 max_restarts: int = 3,
                 attempt_deadline_s: Optional[float] = None,
                 backoff: BackoffPolicy = BackoffPolicy(),
                 grace: GracePolicy = GracePolicy(),
                 env: Optional[dict] = None,
                 log_dir: str | os.PathLike = "resilience-logs",
                 event_log: Optional[events.EventLog] = None,
                 observe_dir: Optional[str | os.PathLike] = None,
                 worker_schedule: Optional[Sequence[int]] = None,
                 device_schedule: Optional[Sequence[int]] = None,
                 rejoin_window_s: float = 0.0,
                 max_rejoins: int = 4,
                 no_restart_exits: Sequence[int] = (EXIT_INTEGRITY,),
                 step_rejoin_dir: Optional[str | os.PathLike] = None,
                 reform_ack_timeout_s: float = 60.0,
                 rank_scoped_env_keys: Sequence[str] = ()):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        for name, sched in (("worker_schedule", worker_schedule),
                            ("device_schedule", device_schedule)):
            if sched is not None and (
                    not sched or any(int(n) < 1 for n in sched)):
                raise ValueError(
                    f"{name} must be a non-empty sequence of positive "
                    f"ints, got {sched!r}")
        if device_schedule is not None and any(int(n) > 1
                                               for n in device_schedule):
            raise unported("Supervisor(device_schedule=) with several "
                           "devices a process", "12b")
        self.cmd = list(cmd)
        self.num_workers = num_workers
        self.max_restarts = max_restarts
        self.attempt_deadline_s = attempt_deadline_s
        self.backoff = backoff
        self.grace = grace
        self.env = dict(env or {})
        self.log_dir = pathlib.Path(log_dir)
        self.events = event_log
        self.observe_dir = (pathlib.Path(observe_dir)
                            if observe_dir is not None else None)
        #: Elastic schedules: entry ``a`` is attempt ``a``'s shape (the
        #: last repeats); a device count is 1 here (one device a process).
        self.worker_schedule = (None if worker_schedule is None
                                else [int(n) for n in worker_schedule])
        self.device_schedule = (None if device_schedule is None
                                else [int(n) for n in device_schedule])
        #: Per-rank relaunch into the same attempt (module docstring).
        self.rejoin_window_s = float(rejoin_window_s)
        self.max_rejoins = int(max_rejoins)
        #: Exit codes that stop supervision instead of triggering a
        #: restart: the worker declared its failure non-recoverable (by
        #: default ``integrity_abort``). Serve supervision empties it.
        self.no_restart_exits = frozenset(int(c) for c in no_restart_exits)
        #: The gang directory of the mid-epoch reform, or None.
        self.step_rejoin_dir = (pathlib.Path(step_rejoin_dir)
                                if step_rejoin_dir is not None else None)
        #: How long survivors get to drain and ack a reform before the
        #: attempt is condemned to a gang restart.
        self.reform_ack_timeout_s = float(reform_ack_timeout_s)
        self.rank_scoped_env_keys = tuple(rank_scoped_env_keys)
        #: The committed gang generation (each reform bumps it) and the
        #: latest reform's consensus restore step (for its replacement).
        self._generation = 0
        self._restore_step: Optional[int] = None

    # -- elastic gang shapes -------------------------------------------------

    def gang_size(self, attempt: int) -> int:
        """Worker count for ``attempt`` (worker_schedule, else static)."""
        if self.worker_schedule is None:
            return self.num_workers
        return self.worker_schedule[min(attempt, len(self.worker_schedule) - 1)]

    def device_count(self, attempt: int) -> Optional[int]:
        """Per-worker device count for ``attempt``, or None."""
        if self.device_schedule is None:
            return None
        return self.device_schedule[min(attempt, len(self.device_schedule) - 1)]

    # -- launching -----------------------------------------------------------

    def _worker_env(self, rank: int, attempt: int, rejoin: int = 0) -> dict:
        env = dict(os.environ)
        env.update(self.env)
        env[events.ATTEMPT_ENV] = str(attempt)
        if self.observe_dir is not None:
            from tpu_dist_torch.observe.telemetry import OBSERVE_DIR_ENV

            env[OBSERVE_DIR_ENV] = str(self.observe_dir / f"rank{rank}")
        workers = self.gang_size(attempt)
        if workers > 1:
            from tpu_dist_torch.cluster.config import make_local_cluster

            # Fresh ports every attempt: rank 0 hosted the rendezvous and
            # took it down with itself; the old port may sit in TIME_WAIT.
            # A replacement joins its attempt's (at its generation's port).
            if rank == 0 and rejoin == 0:
                self._base_port = _free_port()
            cfg = make_local_cluster(workers, base_port=self._base_port)[rank]
            env.update({
                "TF_CONFIG": json.dumps(cfg),
                # The gang coordinates of the file rendezvous layers: a
                # single-process worker is process 0 of its own.
                "TPU_DIST_REJOIN_RANK": str(rank),
                "TPU_DIST_REJOIN_WORLD": str(workers),
            })
        if self.step_rejoin_dir is not None:
            from tpu_dist_torch.cluster import bootstrap

            env[bootstrap.GANG_DIR_ENV] = str(self.step_rejoin_dir)
            env[bootstrap.GENERATION_ENV] = str(self._generation)
        if rejoin:
            # The replacement's incarnation: the injector folds it into
            # its attempt, so an attempt-0 fault does not fire again.
            env["TPU_DIST_GANG_REJOIN"] = str(rejoin)
            if self.step_rejoin_dir is not None:
                # It restores the reform's consensus step, not its dead
                # predecessor's latest ("none": from scratch).
                env["TPU_DIST_RESTORE_STEP"] = (
                    "none" if self._restore_step is None
                    else str(self._restore_step))
        for key in self.rank_scoped_env_keys:
            if env.get(key):
                env[key] = str(pathlib.Path(env[key]) / f"rank{rank}")
        return env

    def worker_log(self, attempt: int, rank: int,
                   rejoin: int = 0) -> pathlib.Path:
        suffix = f"-rejoin{rejoin}" if rejoin else ""
        return self.log_dir / f"attempt{attempt}-rank{rank}{suffix}.log"

    def _spawn(self, rank: int, attempt: int,
               rejoin: int = 0) -> subprocess.Popen:
        # The file object can close right after the spawn; the child holds
        # its own descriptor.
        with open(self.worker_log(attempt, rank, rejoin), "wb") as log:
            return subprocess.Popen(
                self.cmd, env=self._worker_env(rank, attempt, rejoin),
                stdout=log, stderr=subprocess.STDOUT)

    def _launch(self, attempt: int) -> list:
        self.log_dir.mkdir(parents=True, exist_ok=True)
        procs = [self._spawn(rank, attempt)
                 for rank in range(self.gang_size(attempt))]
        self._log("attempt_start", attempt=attempt,
                  pids=[p.pid for p in procs],
                  num_workers=self.gang_size(attempt),
                  device_count=self.device_count(attempt))
        return procs

    def _log(self, event: str, **fields) -> None:
        if self.events is not None:
            try:
                self.events.append(event, **fields)
            except OSError:
                pass

    # -- watching ------------------------------------------------------------

    def _can_rejoin(self, rank: int, code: int, rejoins: int,
                    live_others: bool) -> bool:
        """Per-rank relaunch: rejoin or reform armed, budget left, the
        rest of the gang running, a failure, and not the chief (rank 0
        hosts the rendezvous, whose loss only a gang restart recovers) —
        except under the reform, whose new clique gets a fresh port a
        relaunched rank 0 can host."""
        return ((self.rejoin_window_s > 0
                 or self.step_rejoin_dir is not None)
                and rejoins < self.max_rejoins
                and (rank != 0 or self.step_rejoin_dir is not None)
                and live_others
                and code != 0)

    def _watch(self, procs: list, attempt: int) -> AttemptOutcome:
        """Block until the gang exits, a member fails, or the deadline hits.
        The first nonzero exit (or the deadline) condemns the attempt,
        unless a per-rank relaunch or a reform absorbs it; the survivors
        then get the :class:`GracePolicy` escalation."""
        t0 = time.monotonic()
        deadline = (t0 + self.attempt_deadline_s
                    if self.attempt_deadline_s else None)
        failed = False
        deadline_hit = False
        rejoins = 0
        gang_reforms = 0
        first_failure_t: Optional[float] = None
        # Each rank's last time seen alive: detect_s = detection - this.
        last_alive = {rank: t0 for rank in range(len(procs))}
        reported: set = set()
        while True:
            live = [p for p in procs if p.poll() is None]
            now = time.monotonic()
            for rank, p in enumerate(procs):
                if p.poll() is None:
                    last_alive[rank] = now
            for rank, p in enumerate(procs):
                code = p.poll()
                if code is None or (rank, p.pid) in reported:
                    continue
                reported.add((rank, p.pid))
                self._log("worker_exit", attempt=attempt, rank=rank,
                          code=code, kind=classify_exit(code))
                logger.info("supervisor: rank %d exited %s (%s)",
                            rank, code, classify_exit(code))
                if code == 0:
                    continue
                if first_failure_t is None:
                    first_failure_t = time.monotonic()
                others_live = any(q.poll() is None for q in procs
                                  if q is not p)
                if not self._can_rejoin(rank, code, rejoins, others_live):
                    failed = True
                    continue
                detect_s = time.monotonic() - last_alive[rank]
                if self.step_rejoin_dir is not None:
                    if not self._begin_reform(procs, rank, attempt,
                                              detect_s):
                        failed = True
                        continue
                    gang_reforms += 1
                rejoins += 1
                procs[rank] = self._spawn(rank, attempt, rejoin=rejoins)
                self._log("worker_rejoin", attempt=attempt, rank=rank,
                          rejoin=rejoins, prior_code=code,
                          pid=procs[rank].pid)
                logger.info("supervisor: relaunched rank %d into attempt "
                            "%d (rejoin %d/%d)", rank, attempt, rejoins,
                            self.max_rejoins)
            if failed or not live:
                break
            if deadline is not None and time.monotonic() > deadline:
                deadline_hit = True
                self._log("attempt_deadline", attempt=attempt,
                          deadline_s=self.attempt_deadline_s)
                logger.warning("supervisor: attempt %d exceeded its %.1fs "
                               "deadline", attempt, self.attempt_deadline_s)
                break
            time.sleep(_POLL_S)
        if deadline_hit:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        else:
            grace_end = time.monotonic() + self.grace.exit_grace_s
            while (any(p.poll() is None for p in procs)
                   and time.monotonic() < grace_end):
                time.sleep(_POLL_S)
            termed = [rank for rank, p in enumerate(procs)
                      if p.poll() is None]
            if termed:
                for rank in termed:
                    procs[rank].terminate()
                self._log("gang_sigterm", attempt=attempt, ranks=termed,
                          term_grace_s=self.grace.term_grace_s)
                logger.info("supervisor: SIGTERM to rank(s) %s; waiting "
                            "%.1fs", termed, self.grace.term_grace_s)
                term_end = time.monotonic() + self.grace.term_grace_s
                while (any(p.poll() is None for p in procs)
                       and time.monotonic() < term_end):
                    time.sleep(_POLL_S)
            for rank, p in enumerate(procs):
                if p.poll() is None:
                    self._log("gang_sigkill", attempt=attempt, rank=rank)
                    p.kill()
        codes = []
        for rank, p in enumerate(procs):
            code = p.wait()
            codes.append(code)
            if (rank, p.pid) not in reported:
                self._log("worker_exit", attempt=attempt, rank=rank,
                          code=code, kind=classify_exit(code))
        return AttemptOutcome(attempt=attempt, exit_codes=codes,
                              duration_s=time.monotonic() - t0,
                              deadline_hit=deadline_hit,
                              num_workers=self.gang_size(attempt),
                              device_count=self.device_count(attempt),
                              rejoins=rejoins, gang_reforms=gang_reforms,
                              first_failure_t=first_failure_t)

    def _begin_reform(self, procs: list, lost_rank: int, attempt: int,
                      detect_s: float) -> bool:
        """The Supervisor's side of a mid-epoch gang reform: publish the
        request for generation g+1, wait for every survivor's ack, take
        the consensus restore step (the minimum over the acks' steps and,
        with rank-scoped checkpoint directories, the lost rank's; any None
        is None), commit it and the new generation, and return True (the
        caller spawns the replacement). Returns False, the request
        withdrawn, when a survivor dies mid-reform (a second loss) or the
        acks miss ``reform_ack_timeout_s``: the attempt falls back to a
        gang restart."""
        from tpu_dist_torch.cluster import bootstrap

        new_gen = self._generation + 1
        bootstrap.request_reform(self.step_rejoin_dir, generation=new_gen,
                                 lost_ranks=[lost_rank], detect_s=detect_s)
        survivors = [r for r, p in enumerate(procs)
                     if r != lost_rank and p.poll() is None]
        t0 = time.monotonic()
        ack_deadline = t0 + self.reform_ack_timeout_s
        while True:
            acks = bootstrap.read_reform_acks(self.step_rejoin_dir,
                                              generation=new_gen)
            if set(survivors) <= set(acks):
                break
            dead = [r for r in survivors if procs[r].poll() is not None]
            if dead:
                bootstrap.withdraw_reform(self.step_rejoin_dir)
                self._log("gang_reform_failed", attempt=attempt,
                          generation=new_gen, reason="survivor_died",
                          cause="second_loss", ranks=dead)
                logger.warning("supervisor: survivor rank(s) %s died "
                               "mid-reform (second loss); falling back to "
                               "gang restart", dead)
                return False
            if time.monotonic() > ack_deadline:
                bootstrap.withdraw_reform(self.step_rejoin_dir)
                self._log("gang_reform_failed", attempt=attempt,
                          generation=new_gen, reason="ack_timeout",
                          cause="ack_timeout", acked=sorted(acks),
                          survivors=survivors)
                logger.warning(
                    "supervisor: reform acks %s/%s within %.1fs; falling "
                    "back to gang restart", sorted(acks), survivors,
                    self.reform_ack_timeout_s)
                return False
            time.sleep(_POLL_S)
        ack_wait_s = time.monotonic() - t0
        steps = [acks[r].get("available_step") for r in survivors]
        if self.rank_scoped_env_keys:
            # The replacement restores from the lost rank's own directory,
            # which may be behind the survivors' (its async save may not
            # have published before it died).
            steps.append(self._lost_rank_step(lost_rank))
        consensus = None if any(s is None for s in steps) else min(steps)
        bootstrap.publish_restore_step(self.step_rejoin_dir,
                                       generation=new_gen, step=consensus)
        self._restore_step = consensus
        self._generation = new_gen
        bootstrap.publish_generation(self.step_rejoin_dir, new_gen)
        self._log("gang_reform_requested", attempt=attempt,
                  generation=new_gen, lost_ranks=[lost_rank],
                  detect_s=round(detect_s, 6),
                  ack_wait_s=round(ack_wait_s, 6), restore_step=consensus)
        logger.info("supervisor: gang reform to generation %d (lost rank "
                    "%d, restore step %s, acks in %.3fs)", new_gen,
                    lost_rank, consensus, ack_wait_s)
        return True

    def _lost_rank_step(self, lost_rank: int) -> Optional[int]:
        """The newest complete checkpoint step in the lost rank's
        rank-scoped checkpoint directory, or None."""
        for key in self.rank_scoped_env_keys:
            base = self.env.get(key) or os.environ.get(key)
            if not base:
                continue
            from tpu_dist_torch.training import checkpoint as ckpt_lib

            try:
                return ckpt_lib.latest_complete_step(
                    pathlib.Path(base) / f"rank{lost_rank}")
            except OSError:
                return None
        return None

    def _attempt_drain_s(self, attempt: int) -> Optional[float]:
        """Longest drain any rank of ``attempt`` reported, from the shared
        event log's ``preempt_drained`` records; None without the log."""
        if self.events is None:
            return None
        drained = [e.get("drain_s") for e in
                   events.read_events(self.events.path,
                                      event="preempt_drained")
                   if e.get("attempt") == attempt
                   and isinstance(e.get("drain_s"), (int, float))]
        return max(drained) if drained else None

    # -- the supervision loop ------------------------------------------------

    def run(self) -> SupervisorReport:
        t_start = time.monotonic()
        t_first_failure: Optional[float] = None
        outcomes: list = []
        attempt = 0
        while True:
            outcome = self._watch(self._launch(attempt), attempt)
            outcome.drain_s = self._attempt_drain_s(attempt)
            outcomes.append(outcome)
            if t_first_failure is None:
                t_first_failure = outcome.first_failure_t
            if outcome.succeeded:
                if attempt > 0 or outcome.rejoins:
                    self._log("recovered", attempt=attempt,
                              restarts=attempt, rejoins=outcome.rejoins,
                              gang_reforms=outcome.gang_reforms)
                break
            if t_first_failure is None:
                t_first_failure = time.monotonic()
            fatal = [c for c in outcome.exit_codes
                     if c is not None and c in self.no_restart_exits]
            if fatal:
                logger.error("supervisor: worker exited %s (%s) — "
                             "restarting cannot help; stopping",
                             fatal[0], classify_exit(fatal[0]))
                self._log("no_restart_stop", attempt=attempt,
                          exit_codes=outcome.exit_codes,
                          kinds=[classify_exit(c) for c in fatal])
                break
            if attempt >= self.max_restarts:
                logger.error("supervisor: restart budget (%d) exhausted",
                             self.max_restarts)
                break
            delay = self.backoff.delay(attempt)
            self._log("restart", attempt=attempt + 1, backoff_s=delay,
                      prior_exit_codes=outcome.exit_codes)
            logger.info("supervisor: restarting (attempt %d) after %.2fs "
                        "backoff", attempt + 1, delay)
            time.sleep(delay)
            attempt += 1
        wall = time.monotonic() - t_start
        success = outcomes[-1].succeeded
        recovery = (time.monotonic() - t_first_failure
                    if success and t_first_failure is not None else None)
        report = SupervisorReport(
            success=success, attempts=len(outcomes),
            restarts=len(outcomes) - 1, outcomes=outcomes,
            wall_time_s=wall, recovery_wall_s=recovery)
        self._log("run_complete", **report.to_json())
        return report
