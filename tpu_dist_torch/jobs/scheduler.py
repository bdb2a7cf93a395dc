"""Packing scheduler + JobPool: N jobs, one pool, per-job fault domains.

Counterpart of ``tpu_dist/jobs/scheduler.py``: the same decisions on the
same submissions. A job's gang is its slice size in processes here (one
device a process), launched with ``Supervisor(worker_schedule=)`` over
gloo where the reference forces a device count in one process; every
process runs on the pool's ``device``.

Two layers, split so each is testable alone:

* :class:`PackingScheduler` is the pure decision core — a priority queue
  (higher ``priority`` first, FIFO within a priority) over submitted
  :class:`JobRecord`\\ s and the ``queued -> running -> done|failed``
  state machine. Admission is *backfilling*: the queue is walked in
  priority order and the first job whose submesh request fits a free
  slice is admitted, so a wide job waiting for half the pool does not
  starve the narrow jobs behind it (the walk order still guarantees the
  wide job is offered every freed slice first).

* :class:`JobPool` executes the schedule: each admitted job runs as its
  own **supervised worker gang** (one
  :class:`~tpu_dist_torch.resilience.supervisor.Supervisor` per job — gang
  semantics per job, not per pool), as many processes as the job's leased
  slice has slots. Per-job fault domains fall out
  of that shape: a ``job_kill@jobN`` fault is armed only inside gang N
  (the injector filters on ``$TPU_DIST_JOB_INDEX``), its supervisor
  restarts only gang N, and every other job's processes, checkpoints,
  event logs and RNG streams are untouched — the blast-radius gate
  asserts survivors at zero restarts and exact solo parity. A worker
  exiting :data:`~tpu_dist_torch.resilience.faults.EXIT_JOB_ABORT` is not
  restarted (the job-level "restart cannot help" verdict): its job is
  marked ``failed`` with classification ``job_abort`` and its slice is
  released to the next queued job.
"""

from __future__ import annotations

import os
import pathlib
import sys
import threading
import time
from typing import Optional, Sequence, Union

from tpu_dist_torch.jobs.runtime import MeshRuntime, SubmeshLease
from tpu_dist_torch.jobs.spec import (JOB_ROOT_ENV, JOB_SPEC_ENV,
                                      JobNamespace, JobSpec)
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (EXIT_INTEGRITY, EXIT_JOB_ABORT,
                                              FAULT_PLAN_ENV, JOB_INDEX_ENV,
                                              FaultPlan, classify_exit_code)

#: Job states (the state machine: QUEUED -> RUNNING -> DONE | FAILED).
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


class JobRecord:
    """One submitted job's mutable scheduling state (specs stay frozen)."""

    def __init__(self, spec: JobSpec, index: int):
        self.spec = spec
        self.index = index            # submission index == @jobN coordinate
        self.state = QUEUED
        self.lease: Optional[SubmeshLease] = None
        self.restarts = 0
        self.classification: Optional[str] = None  # failed: why
        self.result: Optional[dict] = None         # worker RESULT payload
        self.report: Optional[dict] = None         # SupervisorReport.to_json
        self.started_s: Optional[float] = None
        self.duration_s: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "name": self.spec.name, "index": self.index,
            "kind": self.spec.kind, "devices": self.spec.devices,
            "priority": self.spec.priority, "state": self.state,
            "restarts": self.restarts,
            "classification": self.classification,
            "duration_s": (None if self.duration_s is None
                           else round(self.duration_s, 4)),
            "result": self.result,
        }


class PackingScheduler:
    """Priority + FIFO-within-priority admission over a static partition.

    Pure bookkeeping: the caller owns the :class:`MeshRuntime` and asks
    :meth:`next_admissible` which queued job to place next; transitions
    go through :meth:`mark_running` / :meth:`mark_done` /
    :meth:`mark_failed`. Submission validates the divisor rule
    immediately — a job that can never fit must fail at submit time, not
    sit queued forever.
    """

    def __init__(self, runtime: MeshRuntime):
        self.runtime = runtime
        self.records: list[JobRecord] = []

    def submit(self, spec: JobSpec) -> JobRecord:
        self.runtime.validate_request(spec.devices)
        if any(r.spec.name == spec.name for r in self.records):
            raise ValueError(f"duplicate job name {spec.name!r}: names key "
                             f"namespaces (checkpoints, metrics, events)")
        record = JobRecord(spec, index=len(self.records))
        self.records.append(record)
        return record

    # -- queue views ---------------------------------------------------------

    def queued(self) -> list[JobRecord]:
        """Queued jobs in admission order: priority desc, then FIFO."""
        return sorted((r for r in self.records if r.state == QUEUED),
                      key=lambda r: (-r.spec.priority, r.index))

    def running(self) -> list[JobRecord]:
        return [r for r in self.records if r.state == RUNNING]

    def settled(self) -> bool:
        return all(r.state in (DONE, FAILED) for r in self.records)

    def next_admissible(self) -> Optional[tuple[JobRecord, SubmeshLease]]:
        """The highest-priority queued job a free slice fits, with its
        lease already taken — or None when nothing placeable right now."""
        for record in self.queued():
            lease = self.runtime.try_acquire(record.spec.devices)
            if lease is not None:
                return record, lease
        return None

    # -- transitions ---------------------------------------------------------

    def mark_running(self, record: JobRecord, lease: SubmeshLease) -> None:
        assert record.state == QUEUED, record.state
        record.state = RUNNING
        record.lease = lease
        record.started_s = time.monotonic()

    def _settle(self, record: JobRecord, state: str) -> None:
        assert record.state == RUNNING, record.state
        record.state = state
        if record.started_s is not None:
            record.duration_s = time.monotonic() - record.started_s
        if record.lease is not None and not record.lease.released:
            record.lease.release()

    def mark_done(self, record: JobRecord) -> None:
        self._settle(record, DONE)

    def mark_failed(self, record: JobRecord,
                    classification: Optional[str] = None) -> None:
        record.classification = classification
        self._settle(record, FAILED)


def _job_worker_cmd(device: Optional[str] = None) -> list:
    cmd = [sys.executable, "-m", "tpu_dist_torch.jobs.worker"]
    if device is not None:
        cmd += ["--device", device]
    return cmd


def _pool_env(extra: dict) -> dict:
    """os.environ minus any job, resilience, observe or gang wiring of OUR
    caller (a pool run inside a supervised run must not inherit its plan
    or its cluster), plus ``extra``."""
    from tpu_dist_torch.cluster import bootstrap
    from tpu_dist_torch.observe.telemetry import OBSERVE_DIR_ENV
    from tpu_dist_torch.resilience.entrypoints import CHECKPOINT_DIR_ENV
    from tpu_dist_torch.serve.journal import JOURNAL_DIR_ENV

    drop = (FAULT_PLAN_ENV, events.EVENT_LOG_ENV, events.ATTEMPT_ENV,
            CHECKPOINT_DIR_ENV, OBSERVE_DIR_ENV, JOURNAL_DIR_ENV,
            JOB_SPEC_ENV, JOB_ROOT_ENV, JOB_INDEX_ENV, "TF_CONFIG",
            bootstrap.REJOIN_DIR_ENV, bootstrap.GANG_DIR_ENV,
            bootstrap.GENERATION_ENV, "TPU_DIST_REJOIN_RANK",
            "TPU_DIST_REJOIN_WORLD")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(extra)
    return env


class JobPool:
    """Run a mix of jobs packed onto one pool, one supervised gang each.

    Args:
      specs: the jobs, in submission order (index i == ``@jobi``).
      root: namespace root — per-job checkpoints/events/logs live under
        ``<root>/jobs/<name>/``.
      pool: device pool — an int (a virtual pool: each job's gang is
        its slice size in processes) or a device list.
      plan: a :class:`FaultPlan` (or compact string) broadcast to every
        gang; job-coordinate faults self-filter by ``$TPU_DIST_JOB_INDEX``.
      max_restarts / attempt_deadline_s / backoff_s: per-job supervisor
        budget — each job spends its own, never a neighbor's.
      device: every job process's device (``--device``; CUDA unless
        ``"cpu"``).
    """

    def __init__(self, specs: Sequence[JobSpec], *,
                 root: Union[str, os.PathLike],
                 pool: Union[int, Sequence, None] = 8,
                 plan: Union[FaultPlan, str, None] = None,
                 max_restarts: int = 2,
                 attempt_deadline_s: float = 180.0,
                 backoff_s: float = 0.1,
                 device: Optional[str] = None):
        self.root = pathlib.Path(root)
        self.device = device
        self.runtime = MeshRuntime(pool)
        self.scheduler = PackingScheduler(self.runtime)
        for spec in specs:
            self.scheduler.submit(spec)
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        self.plan = plan
        self.max_restarts = int(max_restarts)
        self.attempt_deadline_s = float(attempt_deadline_s)
        self.backoff_s = float(backoff_s)
        self._cond = threading.Condition()
        self._threads: list[threading.Thread] = []

    # -- per-job execution ---------------------------------------------------

    def _job_env(self, record: JobRecord, ns: JobNamespace) -> dict:
        from tpu_dist_torch.resilience.entrypoints import CHECKPOINT_DIR_ENV
        from tpu_dist_torch.serve.journal import JOURNAL_DIR_ENV

        extra = {
            JOB_SPEC_ENV: record.spec.dumps(),
            JOB_ROOT_ENV: str(self.root),
            JOB_INDEX_ENV: str(record.index),
            events.EVENT_LOG_ENV: str(ns.event_log),
            CHECKPOINT_DIR_ENV: str(ns.checkpoint_dir),
        }
        if record.spec.kind == "serve":
            extra[JOURNAL_DIR_ENV] = str(ns.journal_dir)
        if self.plan is not None and self.plan:
            extra[FAULT_PLAN_ENV] = self.plan.dumps()
        return _pool_env(extra)

    def _run_job(self, record: JobRecord, lease: SubmeshLease) -> None:
        from tpu_dist_torch.observe import metrics
        from tpu_dist_torch.resilience.cli import parse_result_line
        from tpu_dist_torch.resilience.supervisor import (BackoffPolicy,
                                                          Supervisor)
        from tpu_dist_torch.serve.journal import JOURNAL_DIR_ENV

        ns = JobNamespace(record.spec, self.root)
        ns.job_dir.mkdir(parents=True, exist_ok=True)
        sup = Supervisor(
            _job_worker_cmd(self.device),
            max_restarts=self.max_restarts,
            attempt_deadline_s=self.attempt_deadline_s,
            backoff=BackoffPolicy(initial_s=self.backoff_s),
            env=self._job_env(record, ns),
            log_dir=ns.log_dir,
            event_log=events.EventLog(
                ns.event_log, role=f"job{record.index}-supervisor"),
            observe_dir=ns.observe_dir,
            # The gang is the job's leased slice, one process a slot: the
            # submesh, in subprocess clothing.
            worker_schedule=[lease.size],
            no_restart_exits=(EXIT_INTEGRITY, EXIT_JOB_ABORT),
            # A serve gang's processes are replicas: a journal each.
            rank_scoped_env_keys=((JOURNAL_DIR_ENV,)
                                  if record.spec.kind == "serve" else ()),
        )
        try:
            report = sup.run()
            record.report = report.to_json()
            record.restarts = report.restarts
            result = None
            if report.success:
                result = parse_result_line(sup.worker_log(
                    report.attempts - 1, 0).read_text(errors="replace"))
            record.result = result
            with self._cond:
                if report.success and result is not None:
                    self.scheduler.mark_done(record)
                else:
                    last_codes = [c for o in report.outcomes
                                  for c in o.exit_codes
                                  if c not in (None, 0)]
                    # In a gang of several processes the failed rank's
                    # peers exit on the supervisor's signal: the job's
                    # verdict is a no-restart code when one was given.
                    fatal = [c for c in last_codes
                             if c in (EXIT_INTEGRITY, EXIT_JOB_ABORT)]
                    self.scheduler.mark_failed(
                        record,
                        classification=(
                            classify_exit_code((fatal or last_codes)[-1])
                            if last_codes else "crash"))
                self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001 - a job must never wedge the pool
            with self._cond:
                self.scheduler.mark_failed(record,
                                           classification=f"pool_error:{exc}")
                self._cond.notify_all()
        metrics.inc(ns.metric("restarts"), record.restarts)
        if record.duration_s is not None:
            metrics.set_gauge(ns.metric("duration_s"), record.duration_s)

    # -- the pool loop -------------------------------------------------------

    def run(self) -> dict:
        """Admit, execute, and settle every job; returns the pool report."""
        start = time.monotonic()
        with self._cond:
            while not self.scheduler.settled():
                placed = self.scheduler.next_admissible()
                if placed is not None:
                    record, lease = placed
                    self.scheduler.mark_running(record, lease)
                    t = threading.Thread(
                        target=self._run_job, args=(record, lease),
                        name=f"job-{record.index}-{record.spec.name}",
                        daemon=True)
                    self._threads.append(t)
                    t.start()
                    continue  # keep placing until nothing fits
                self._cond.wait(timeout=0.25)
        for t in self._threads:
            t.join()
        makespan = time.monotonic() - start
        records = [r.to_json() for r in self.scheduler.records]
        return {
            "pool_devices": self.runtime.pool_size,
            "makespan_s": round(makespan, 4),
            "jobs": records,
            "done": sum(1 for r in records if r["state"] == DONE),
            "failed": sum(1 for r in records if r["state"] == FAILED),
        }
