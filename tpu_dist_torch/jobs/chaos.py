"""Multi-job chaos: per-job fault domains with a blast-radius-zero gate.

Counterpart of ``tpu_dist/jobs/chaos.py``, with the same phases and gates.
The multi-tenant counterpart of the training and serve chaos suites,
reached through ``python -m tpu_dist_torch.jobs --chaos``. The claim under test
is the one that makes packing safe to offer at all: **a fault in job N is
job N's problem** — its gang restarts (or is abandoned), and every other
job on the pool keeps its exact solo timeline.

Three phases, one report:

* **solo baselines** — every job in the mix runs alone (same gang shape
  as packed: as many processes as its slice has slots). Its worker RESULT —
  the full per-epoch loss series for train jobs, the per-request greedy
  token streams for serve jobs — is THE parity reference.
* **kill phase** (plan default ``job_kill@job1``) — the packed pool runs
  with the plan armed; the injector inside gang 1 fires, gang 1 dies
  with :data:`~tpu_dist_torch.resilience.faults.EXIT_FAULT_KILL`, its own
  supervisor restarts it, and it recovers to completion. Gates: the
  fault actually fired, in the *target's* event log only (anti-vacuity +
  domain isolation); every survivor finished with **zero restarts** and
  results bit-identical to solo (blast radius zero); the target itself
  recovered with >= 1 restart and exact solo parity.
* **abort phase** (plan default ``job_kill@job1:abort``) — same mix, but
  the fault exits :data:`~tpu_dist_torch.resilience.faults.EXIT_JOB_ABORT`:
  the job-level "restart cannot help" verdict. Gates: the target is
  ``failed`` with classification ``job_abort`` and **zero** restarts
  (the supervisor must not retry a hopeless job), and the survivors'
  blast-radius gate holds exactly as in the kill phase.

The report is JSON on stdout; exit 0 iff every gate passes.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile
from typing import Optional

from tpu_dist_torch.jobs.cli import chaos_mix, run_solo
from tpu_dist_torch.jobs.scheduler import DONE, FAILED, JobPool
from tpu_dist_torch.jobs.spec import JobNamespace, JobSpec
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (EXIT_JOB_ABORT, JOB_KINDS,
                                              FaultPlan, describe)


def _parity(kind: str, solo: Optional[dict],
            packed: Optional[dict]) -> bool:
    """Exact-result equality: full loss series for train jobs, full token
    streams for serve jobs. Bitwise, not approximate — the namespaces
    make packed runs deterministic replicas of solo runs, so anything
    short of equality is leakage."""
    if solo is None or packed is None:
        return False
    if kind == "train":
        return (solo.get("losses") == packed.get("losses")
                and solo.get("final_loss") == packed.get("final_loss")
                and solo.get("losses"))
    return (solo.get("streams") == packed.get("streams")
            and bool(solo.get("streams")))


def _fired(root: pathlib.Path, spec: JobSpec) -> list[dict]:
    """fault_fired records in one job's namespaced event log."""
    log = JobNamespace(spec, root).event_log
    if not log.exists():
        return []
    return events.read_events(log, "fault_fired")


def _run_phase(args, mix: list[JobSpec], plan: FaultPlan,
               solo: dict, root: pathlib.Path) -> dict:
    """One packed run under ``plan``, fully gated against ``solo``."""
    job_faults = [f for f in plan.faults if f.kind in JOB_KINDS]
    targets = {f.job for f in job_faults}
    abort_targets = {f.job for f in job_faults
                     if f.exit_code == EXIT_JOB_ABORT}
    packed = JobPool(mix, root=root, pool=args.pool, plan=plan,
                     max_restarts=args.max_restarts,
                     attempt_deadline_s=args.deadline,
                     device=args.device).run()
    by_index = {j["index"]: j for j in packed["jobs"]}

    failures: list[str] = []
    fired_by_job: dict[int, int] = {}
    for spec, job in zip(mix, packed["jobs"]):
        idx = job["index"]
        fired = _fired(root, spec)
        fired_by_job[idx] = len(fired)
        if idx in targets:
            wanted = {f.kind for f in job_faults if f.job == idx}
            got = {r.get("kind") for r in fired}
            if not (wanted & got):
                failures.append(
                    f"job {idx} ({spec.name}): no {sorted(wanted)} fault "
                    f"fired — vacuous chaos run")
        elif fired:
            # Domain isolation: a fault record in a neighbor's log means
            # the @jobN filter leaked across gang boundaries.
            failures.append(
                f"job {idx} ({spec.name}): {len(fired)} fault(s) fired in "
                f"a non-target job — fault domain leaked")

    for spec, job in zip(mix, packed["jobs"]):
        idx = job["index"]
        base = solo[spec.name].get("result")
        if idx in abort_targets:
            if job["state"] != FAILED:
                failures.append(
                    f"job {idx} ({spec.name}): aborted job ended "
                    f"{job['state']!r}, want failed")
            elif job["classification"] != "job_abort":
                failures.append(
                    f"job {idx} ({spec.name}): classification "
                    f"{job['classification']!r}, want 'job_abort'")
            if job["restarts"] != 0:
                failures.append(
                    f"job {idx} ({spec.name}): {job['restarts']} restart(s) "
                    f"of a no-restart abort — supervisor retried a "
                    f"hopeless job")
        elif idx in targets:
            if job["state"] != DONE:
                failures.append(
                    f"job {idx} ({spec.name}): fault target did not "
                    f"recover (state {job['state']!r})")
            elif job["restarts"] < 1:
                failures.append(
                    f"job {idx} ({spec.name}): killed job finished with no "
                    f"restart — the kill never landed (vacuous)")
            elif not _parity(spec.kind, base, job.get("result")):
                failures.append(
                    f"job {idx} ({spec.name}): recovered result diverged "
                    f"from solo baseline")
        else:
            if job["state"] != DONE:
                failures.append(
                    f"job {idx} ({spec.name}): survivor did not finish "
                    f"(state {job['state']!r}) — blast radius nonzero")
            elif job["restarts"] != 0:
                failures.append(
                    f"job {idx} ({spec.name}): survivor restarted "
                    f"{job['restarts']}x — blast radius nonzero")
            elif not _parity(spec.kind, base, job.get("result")):
                failures.append(
                    f"job {idx} ({spec.name}): survivor result diverged "
                    f"from solo baseline — isolation broken")

    return {
        "plan": plan.to_json(),
        "pool": packed,
        "faults_fired_by_job": fired_by_job,
        "targets": sorted(targets),
        "abort_targets": sorted(abort_targets),
        "failures": failures,
        "ok": not failures,
        "_by_index": by_index,
    }


def run_chaos(args) -> int:
    """``--chaos`` mode: solo baselines, then the kill and abort phases;
    print the gated JSON report, exit 0 iff every gate holds."""
    plan = FaultPlan.parse(args.plan or "job_kill@job1")
    if not any(f.kind in JOB_KINDS for f in plan.faults):
        print("error: --chaos needs a plan with at least one job fault "
              "(job_kill@jobN / job_hang@jobN:Ss)", file=sys.stderr)
        return 2
    abort_plan = (FaultPlan.parse(args.abort_plan)
                  if args.abort_plan else None)
    mix = chaos_mix()
    n_jobs = len(mix)
    for f in plan.faults:
        if f.job is not None and f.job >= n_jobs:
            print(f"error: plan targets job {f.job} but the mix has "
                  f"{n_jobs} jobs", file=sys.stderr)
            return 2
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
        prefix="tpu-dist-jobs-chaos-"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"jobs chaos workdir: {workdir}", file=sys.stderr)
    for line in describe(plan):
        print(f"fault: {line}", file=sys.stderr)

    solo: dict[str, dict] = {}
    for spec in mix:
        print(f"baseline: running {spec.name} solo...", file=sys.stderr)
        solo[spec.name] = run_solo(
            spec, root=workdir / "solo" / spec.name, pool=args.pool,
            max_restarts=args.max_restarts, deadline_s=args.deadline,
            device=args.device)
    bad = [n for n, j in solo.items() if j["state"] != DONE]
    if bad:
        print(f"error: solo baseline(s) failed: {bad}", file=sys.stderr)
        return 1

    report: dict = {
        "mix": [s.to_json() for s in mix],
        "pool_devices": args.pool,
        "workdir": str(workdir),
        "solo": solo,
    }
    ok = True

    print("kill phase: packed run with the plan armed...", file=sys.stderr)
    kill = _run_phase(args, mix, plan, solo, workdir / "packed-kill")
    kill.pop("_by_index")
    report["kill"] = kill
    ok = ok and kill["ok"]

    if abort_plan is not None:
        print("abort phase: packed run with the abort plan armed...",
              file=sys.stderr)
        abort = _run_phase(args, mix, abort_plan, solo,
                           workdir / "packed-abort")
        abort.pop("_by_index")
        report["abort"] = abort
        ok = ok and abort["ok"]

    report["ok"] = ok
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    return 0 if ok else 1
