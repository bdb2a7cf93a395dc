"""``python -m tpu_dist_torch.resilience`` — a chaos experiment and its report.

Counterpart of ``tpu_dist/resilience/cli.py``'s ``--plan`` mode. The
experiment runs the entry point once uninterrupted (the baseline), then
again under the :class:`~tpu_dist_torch.resilience.supervisor.Supervisor`
with a fault plan armed, and compares. The JSON report answers:

* did the faults fire (``faults_fired``, from the event log; a run whose
  fault never fired is vacuous and FAILS);
* how many restarts recovery took (``restarts``) and what it cost
  (``recovery_wall_s``);
* did the recovered run end where the baseline did (``final_loss``
  against ``baseline_final_loss``, within ``--parity-atol``).

Anti-vacuity gates: a ``preempt`` plan must show a ``preempted`` exit and a
``preempt_drained`` event; an integrity plan (``nan_loss``, ``grad_spike``,
``corrupt_batch``, ``bitflip``) arms ``TPU_DIST_INTEGRITY`` in both runs
(an armed guard must change nothing on the clean baseline) and must show
an in-process rollback and no restart.

Example::

    python -m tpu_dist_torch.resilience --device cpu \\
        --plan kill-worker@step5,kill-during-save@epoch2:attempt1

kills the demo worker at global step 5 of a 12-step run, then on the
restarted attempt kills it inside the epoch-2 checkpoint write; the third
attempt resumes from epoch 1's checkpoint and ends on the baseline's loss.

Differences from the JAX package: ``--device`` (CUDA unless ``cpu``) is
passed to the workers. ``--workers N > 1`` runs the demo data-parallel over
the gang (``TPU_DIST_DEMO_STRATEGY=mirrored``: gloo, one replica a
process). The JAX package runs a ``bitflip`` plan over 8 virtual devices in
one process; the port has one device a process, so it runs bitflip over
``--workers >= 2`` ranks (a replica is a rank) and refuses ``--workers 1``
with a usage error. ``--ps-chaos`` runs the parameter server's legs
(``resilience/ps_chaos.py``): straggler against the synchronous control,
kill-worker and server-kill, each process on ``--device``.

Elasticity, the reference's two modes:

* ``--step-rejoin`` runs the same kill plan through two supervised legs of
  a >= 2-worker file gang (single-process workers, rank-scoped checkpoint
  directories, meeting only in the shared directory): the control
  recovers by a gang restart, the reform leg by the mid-epoch gang reform
  (``Supervisor(step_rejoin_dir=)``). Gates: a fault fired in both legs;
  the reform leg has no restart, a ``gang_reform`` and a
  ``worker_rejoin``; its ``recovery_wall_s`` is strictly below the
  control's; its final loss equals the baseline's exactly. The report
  carries ``recovery_breakdown`` (``detect_s``, ``drain_s``,
  ``reform_s``, ``restore_s``).
* ``--reshape N,M[,...]`` gives attempt k the k-th count. The reference's
  counts are devices in one process; here they are process counts (one
  device each, ROADMAP item 12b), handed to ``Supervisor(
  worker_schedule=)`` with the demo data-parallel over the gang and
  checkpointing the v2 layout, so the restart restores a step written by
  N processes onto M. It needs a ``reshape_restore`` event; ``--workers``
  beside it is a usage error. The baseline runs in one process.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from typing import Optional

from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.entrypoints import (CHECKPOINT_DIR_ENV,
                                                   ENTRY_ENV)
from tpu_dist_torch.resilience.faults import (FAULT_PLAN_ENV, FaultPlan,
                                              describe)
from tpu_dist_torch.resilience.supervisor import BackoffPolicy, Supervisor

_RESULT_PREFIX = "RESULT:"

#: Fault kinds recovered in the process by the integrity guard
#: (rollback-and-replay) rather than by a gang restart.
INTEGRITY_KINDS = frozenset(
    {"nan_loss", "grad_spike", "bitflip", "corrupt_batch"})


def parse_result_line(text: str) -> Optional[dict]:
    """The LAST ``RESULT:{...}`` line in ``text`` — a restarted worker's log
    holds one per completed run; the last is the one that finished."""
    result = None
    for line in text.splitlines():
        if line.startswith(_RESULT_PREFIX):
            try:
                result = json.loads(line[len(_RESULT_PREFIX):])
            except ValueError:
                continue
    return result


def _worker_cmd(device: Optional[str]) -> list:
    cmd = [sys.executable, "-m", "tpu_dist_torch.resilience.entrypoints"]
    if device is not None:
        cmd += ["--device", device]
    return cmd


def _clean_env(extra: dict) -> dict:
    """os.environ minus any resilience or observe wiring of OUR caller,
    plus ``extra``: each run (baseline, chaos) gets exactly its own
    knobs."""
    from tpu_dist_torch.cluster import bootstrap
    from tpu_dist_torch.observe.telemetry import OBSERVE_DIR_ENV

    env = {k: v for k, v in os.environ.items()
           if k not in (FAULT_PLAN_ENV, events.EVENT_LOG_ENV,
                        events.ATTEMPT_ENV, CHECKPOINT_DIR_ENV,
                        OBSERVE_DIR_ENV, "TF_CONFIG",
                        bootstrap.REJOIN_DIR_ENV, bootstrap.GANG_DIR_ENV,
                        bootstrap.GENERATION_ENV, "TPU_DIST_GANG_REJOIN",
                        "TPU_DIST_RESTORE_STEP", "TPU_DIST_REJOIN_RANK",
                        "TPU_DIST_REJOIN_WORLD")
           and not k.startswith("TPU_DIST_INTEGRITY")}
    env.update(extra)
    return env


def run_baseline(workdir: pathlib.Path, *, timeout: float,
                 device: Optional[str] = None,
                 extra_env: Optional[dict] = None) -> Optional[dict]:
    """One uninterrupted run in a subprocess; returns its RESULT dict."""
    log_path = workdir / "baseline.log"
    env = _clean_env({CHECKPOINT_DIR_ENV: str(workdir / "baseline-ckpt"),
                      **(extra_env or {})})
    with open(log_path, "wb") as log:
        code = subprocess.call(_worker_cmd(device), env=env, stdout=log,
                               stderr=subprocess.STDOUT, timeout=timeout)
    text = log_path.read_text(errors="replace")
    if code != 0:
        raise RuntimeError(
            f"baseline run exited {code}; see {log_path}:\n{text[-2000:]}")
    return parse_result_line(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.resilience",
        description="Fault-injection chaos runner for training jobs: "
                    "baseline run, supervised chaos run, JSON report.")
    p.add_argument("--plan", required=False, default=None,
                   help="fault plan: compact spec (kill-worker@step5; "
                        "bitflip also takes leaf/replica coordinates, "
                        "e.g. bitflip@step9:leaf1:replica1), inline JSON, "
                        "or @path/to/plan.json")
    p.add_argument("--entry", default=None,
                   help="module:callable to train with (default: the "
                        "built-in synthetic-MNIST demo)")
    p.add_argument("--device", default=None,
                   help="the workers' device (default: cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    p.add_argument("--workers", type=int, default=1,
                   help="worker processes (default 1; more run the demo "
                        "data-parallel over gloo)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--deadline", type=float, default=300.0, metavar="S",
                   help="per-attempt wall-clock deadline (turns a hang into "
                        "a restart; default 300)")
    p.add_argument("--backoff", type=float, default=0.5, metavar="S",
                   help="initial restart backoff, doubling per restart")
    p.add_argument("--parity-atol", type=float, default=1e-5,
                   help="max |final_loss - baseline_final_loss| (default "
                        "1e-5)")
    p.add_argument("--workdir", default=None,
                   help="working directory for checkpoints/logs/events "
                        "(default: a fresh temp dir)")
    p.add_argument("--report", default=None,
                   help="also write the JSON report to this path")
    p.add_argument("--no-baseline", action="store_true",
                   help="skip the baseline run (no parity check)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="overall per-run timeout for the baseline")
    p.add_argument("--step-rejoin", action="store_true",
                   help="mid-epoch gang-reform scenario: the same kill plan "
                        "twice on a >= 2-worker gang, once recovering by a "
                        "gang restart (the control), once by the mid-epoch "
                        "reform; gates on the reform's recovery_wall_s "
                        "strictly below the control's, no restart, >= 1 "
                        "gang_reform, and exact loss parity with the "
                        "baseline")
    p.add_argument("--reshape", default=None, metavar="N,M[,...]",
                   help="elastic reshape schedule: attempt k runs on the "
                        "k-th PROCESS count (last repeats), e.g. 2,1 = die "
                        "on 2 processes, restart reshaped onto 1; the demo "
                        "trains data-parallel with v2 sharded checkpoints "
                        "and a reshape_restore must happen. The baseline "
                        "runs in one process")
    p.add_argument("--ps-chaos", action="store_true",
                   help="parameter-server chaos legs instead of a --plan "
                        "run: calibrated 10x straggler (async vs a "
                        "measured sync collapse), kill-worker (zero "
                        "restarts), server-kill (checkpoint restore). "
                        "Fault plans are derived per leg; --plan is "
                        "ignored")
    p.add_argument("--ps-world", type=int, default=2,
                   help="PS worker ranks per leg (default 2)")
    p.add_argument("--ps-epochs", type=int, default=2)
    p.add_argument("--ps-steps", type=int, default=4,
                   help="steps per epoch per worker (budget = "
                        "epochs*steps*world)")
    p.add_argument("--ps-batch", type=int, default=8)
    p.add_argument("--ps-staleness", type=int, default=4,
                   help="bounded-staleness window for the async legs")
    p.add_argument("--ps-tol", type=float, default=0.1,
                   help="max |final_loss| delta for the PS convergence "
                        "gates (bounded staleness reorders applies, so "
                        "this is a convergence tolerance, not parity)")
    p.add_argument("--ps-legs", default="all",
                   help="comma subset of straggler,kill,server,sync (or "
                        "'all'); the clean async reference leg always "
                        "runs")
    return p


def _demo_env(plan: FaultPlan, workers: int) -> dict:
    """The workers' demo and guard knobs for ``plan``."""
    env = {}
    if workers > 1:
        env["TPU_DIST_DEMO_STRATEGY"] = "mirrored"
    if any(f.kind in INTEGRITY_KINDS for f in plan.faults):
        env.update({"TPU_DIST_INTEGRITY": "1",
                    "TPU_DIST_INTEGRITY_BUDGET": "3"})
        if any(f.kind == "bitflip" for f in plan.faults):
            env["TPU_DIST_INTEGRITY_AUDIT_N"] = "2"
    return env


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.ps_chaos:
        workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
            prefix="tpu-dist-chaos-"))
        workdir.mkdir(parents=True, exist_ok=True)
        print(f"chaos workdir: {workdir}", file=sys.stderr)
        from tpu_dist_torch.resilience.ps_chaos import run_ps_chaos

        return run_ps_chaos(args, workdir)
    if not args.plan:
        print("error: --plan is required (or use --ps-chaos)",
              file=sys.stderr)
        return 2
    plan = FaultPlan.parse(args.plan)
    if not plan:
        print("error: --plan parsed to an empty fault plan", file=sys.stderr)
        return 2
    if any(f.kind == "bitflip" for f in plan.faults) and args.workers < 2:
        print("error: a bitflip plan needs --workers >= 2: the SDC audit "
              "compares replicas, and a replica is a worker process here "
              "(one device each)", file=sys.stderr)
        return 2
    if args.step_rejoin and args.reshape:
        print("error: --step-rejoin and --reshape are mutually exclusive",
              file=sys.stderr)
        return 2
    reshape = _parse_reshape(args.reshape)
    if reshape and args.workers != 1:
        print("error: --reshape gives every attempt's process count; "
              "--workers does not go with it", file=sys.stderr)
        return 2
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
        prefix="tpu-dist-chaos-"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"chaos workdir: {workdir}", file=sys.stderr)
    for line in describe(plan):
        print(f"fault: {line}", file=sys.stderr)
    if args.step_rejoin:
        return _run_step_rejoin(args, plan, workdir)
    demo_env = _demo_env(plan, max(reshape or [args.workers]))
    if reshape:
        demo_env["TPU_DIST_DEMO_SHARDED"] = "1"
    integrity_faults = [f for f in plan.faults if f.kind in INTEGRITY_KINDS]

    baseline = None
    if not args.no_baseline:
        print("running baseline (no faults)...", file=sys.stderr)
        baseline_env = {k: v for k, v in demo_env.items()
                        if k != "TPU_DIST_DEMO_STRATEGY"}
        if args.entry:
            baseline_env[ENTRY_ENV] = args.entry
        baseline = run_baseline(workdir, timeout=args.timeout,
                                device=args.device, extra_env=baseline_env)

    event_path = workdir / "events.jsonl"
    extra_env = {
        FAULT_PLAN_ENV: plan.dumps(),
        events.EVENT_LOG_ENV: str(event_path),
        CHECKPOINT_DIR_ENV: str(workdir / "ckpt"),
        **demo_env,
    }
    if args.entry:
        extra_env[ENTRY_ENV] = args.entry
    print("running chaos experiment...", file=sys.stderr)
    sup = Supervisor(
        _worker_cmd(args.device), num_workers=args.workers,
        max_restarts=args.max_restarts, attempt_deadline_s=args.deadline,
        backoff=BackoffPolicy(initial_s=args.backoff),
        env=_clean_env(extra_env), log_dir=workdir / "logs",
        event_log=events.EventLog(event_path, role="supervisor"),
        observe_dir=workdir / "observe", worker_schedule=reshape)
    sup_report = sup.run()

    final = None
    if sup_report.success:
        final = parse_result_line(sup.worker_log(
            sup_report.attempts - 1, 0).read_text(errors="replace"))
    report = _report(plan, workdir, event_path, sup_report, final)
    ok = report.pop("_ok")
    if reshape and not report["reshape_restores"]:
        ok = False
        report["failure"] = ("--reshape given but no reshape_restore "
                             "happened — vacuous reshape run")
    if integrity_faults:
        ok = _integrity_gate(report, event_path, sup_report) and ok
    if baseline is not None:
        report["baseline_final_loss"] = baseline.get("final_loss")
        if (report["final_loss"] is not None
                and report["baseline_final_loss"] is not None):
            delta = abs(report["final_loss"]
                        - report["baseline_final_loss"])
            report["loss_delta"] = delta
            report["parity_ok"] = delta <= args.parity_atol
            ok = ok and report["parity_ok"]
        else:
            report["parity_ok"] = False
            ok = False
    report["ok"] = ok
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    return 0 if ok else 1


def _parse_reshape(arg: Optional[str]) -> Optional[list]:
    if not arg:
        return None
    try:
        counts = [int(tok) for tok in arg.split(",") if tok.strip()]
    except ValueError:
        counts = []
    if len(counts) < 2 or any(n < 1 for n in counts):
        raise SystemExit(
            f"error: --reshape wants >= 2 comma-separated positive process "
            f"counts (e.g. 2,1), got {arg!r}")
    return counts


def _supervised_leg(args, plan, leg_dir: pathlib.Path, *, workers: int,
                    step_rejoin: bool):
    """One supervised chaos run in ``leg_dir``; returns (sup, report,
    event log path). Both legs of ``--step-rejoin`` run through here with
    the same knobs but ``step_rejoin``, so their recovery_wall_s differ by
    the mechanism alone. The workers are single-process (no process group:
    the demo brings one up only under ``TPU_DIST_DEMO_STRATEGY``), each
    the chief of its own rank-scoped checkpoint directory."""
    leg_dir.mkdir(parents=True, exist_ok=True)
    event_path = leg_dir / "events.jsonl"
    extra_env = {
        FAULT_PLAN_ENV: plan.dumps(),
        events.EVENT_LOG_ENV: str(event_path),
        CHECKPOINT_DIR_ENV: str(leg_dir / "ckpt"),
    }
    if args.entry:
        extra_env[ENTRY_ENV] = args.entry
    sup = Supervisor(
        _worker_cmd(args.device), num_workers=workers,
        max_restarts=args.max_restarts, attempt_deadline_s=args.deadline,
        backoff=BackoffPolicy(initial_s=args.backoff),
        env=_clean_env(extra_env), log_dir=leg_dir / "logs",
        event_log=events.EventLog(event_path, role="supervisor"),
        observe_dir=leg_dir / "observe",
        step_rejoin_dir=(leg_dir / "gang") if step_rejoin else None,
        rank_scoped_env_keys=(CHECKPOINT_DIR_ENV,))
    return sup, sup.run(), event_path


def _worst(records, key):
    """The largest ``key`` among ``records`` (the gang moves at its
    slowest rank's pace), or None."""
    vals = [r.get(key) for r in records
            if isinstance(r.get(key), (int, float))]
    return round(max(vals), 6) if vals else None


def _run_step_rejoin(args, plan, workdir: pathlib.Path) -> int:
    """The mid-epoch rejoin experiment: baseline, control (gang restart),
    reform (gang-generation rejoin), and their gates (module docstring)."""
    workers = max(2, args.workers)
    baseline = None
    if not args.no_baseline:
        print("running baseline (no faults)...", file=sys.stderr)
        baseline = run_baseline(
            workdir, timeout=args.timeout, device=args.device,
            extra_env={ENTRY_ENV: args.entry} if args.entry else None)
    print(f"running control leg (gang restart, {workers} workers)...",
          file=sys.stderr)
    _, control, control_events = _supervised_leg(
        args, plan, workdir / "control", workers=workers, step_rejoin=False)
    print("running reform leg (mid-epoch rejoin)...", file=sys.stderr)
    reform_sup, reform, reform_events = _supervised_leg(
        args, plan, workdir / "reform", workers=workers, step_rejoin=True)

    final = None
    if reform.success:
        final = parse_result_line(reform_sup.worker_log(
            reform.attempts - 1, 0).read_text(errors="replace"))
    control_json = control.to_json()
    reform_json = reform.to_json()
    reforms = events.read_events(reform_events, "gang_reform")
    requests = events.read_events(reform_events, "gang_reform_requested")
    rejoins = events.read_events(reform_events, "worker_rejoin")
    fired_control = events.read_events(control_events, "fault_fired")
    fired_reform = events.read_events(reform_events, "fault_fired")
    # Detection is the supervisor's (it watches the gang); drain, reform
    # and restore are the survivors' gang_reform events.
    breakdown = {"detect_s": _worst(requests, "detect_s"),
                 "drain_s": _worst(reforms, "drain_s"),
                 "reform_s": _worst(reforms, "reform_s"),
                 "restore_s": _worst(reforms, "restore_s")}

    def leg(rep, js):
        return {"recovery_wall_s": js["recovery_wall_s"],
                "wall_time_s": js["wall_time_s"],
                "restarts": rep.restarts, "attempts": rep.attempts,
                "exit_codes": js["exit_codes"],
                "exit_kinds": js["exit_kinds"]}

    report = {
        "plan": plan.to_json(),
        "mode": "step_rejoin",
        "workdir": str(workdir),
        "success": control.success and reform.success,
        "step_rejoin": {
            "control": leg(control, control_json),
            "reform": {**leg(reform, reform_json),
                       "rejoins": reform_json["rejoins"],
                       "gang_reforms": reform_json["gang_reforms"]},
        },
        "recovery_wall_s": reform_json["recovery_wall_s"],
        "recovery_breakdown": breakdown,
        "gang_reform_events": len(reforms),
        "final_loss": (final or {}).get("final_loss"),
    }
    failures = []
    if not fired_control or not fired_reform:
        failures.append("no fault fired — vacuous chaos run")
    if reform.restarts != 0:
        failures.append(
            f"reform leg leaned on a gang restart (restarts="
            f"{reform.restarts}) instead of a mid-epoch rejoin")
    if not reforms:
        failures.append("no gang_reform event — vacuous rejoin run")
    if not rejoins:
        failures.append("no worker_rejoin — the lost rank never relaunched")
    ctrl_rec = control_json["recovery_wall_s"]
    ref_rec = reform_json["recovery_wall_s"]
    if ctrl_rec is None or ref_rec is None:
        failures.append("missing recovery_wall_s in a leg")
    elif not ref_rec < ctrl_rec:
        failures.append(
            f"rejoin recovery ({ref_rec:.3f}s) not strictly below "
            f"gang-restart recovery ({ctrl_rec:.3f}s)")
    else:
        report["step_rejoin"]["speedup"] = round(ctrl_rec / ref_rec, 3)
    if baseline is not None:
        report["baseline_final_loss"] = baseline.get("final_loss")
        if (report["final_loss"] is None
                or report["baseline_final_loss"] is None):
            failures.append("missing final loss for the parity check")
            report["parity_ok"] = False
        else:
            delta = abs(report["final_loss"]
                        - report["baseline_final_loss"])
            report["loss_delta"] = delta
            # Exact: the reform replays from the consensus checkpoint with
            # the per-epoch seeds, so no tolerance.
            report["parity_ok"] = delta == 0.0
            if delta != 0.0:
                failures.append(f"loss parity not exact (delta={delta})")
    ok = control.success and reform.success and not failures
    if failures:
        report["failure"] = "; ".join(failures)
    report["ok"] = ok
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    return 0 if ok else 1


def _report(plan: FaultPlan, workdir: pathlib.Path, event_path, sup_report,
            final: Optional[dict]) -> dict:
    """The report's supervision part, with ``_ok``: success, a fault
    fired, and a preempt plan drained."""
    fired = events.read_events(event_path, "fault_fired")
    sup_json = sup_report.to_json()
    drained = events.read_events(event_path, "preempt_drained")
    reshape_events = events.read_events(event_path, "reshape_restore")
    report = {
        "plan": plan.to_json(),
        "workdir": str(workdir),
        "success": sup_report.success,
        "attempts": sup_report.attempts,
        "restarts": sup_report.restarts,
        "recovery_wall_s": sup_json["recovery_wall_s"],
        "wall_time_s": sup_json["wall_time_s"],
        "exit_codes": [o.exit_codes for o in sup_report.outcomes],
        "exit_kinds": sup_json["exit_kinds"],
        "gang_shapes": sup_json["gang_shapes"],
        "drain_s": sup_json["drain_s"],
        "reshape_restores": [
            {k: r.get(k) for k in ("step", "saved_device_count",
                                   "device_count", "saved_process_count",
                                   "process_count")}
            for r in reshape_events],
        "faults_fired": [
            {k: r.get(k) for k in ("kind", "at", "step", "op", "mode")
             if r.get(k) is not None} for r in fired],
        "events": len(events.read_events(event_path)),
        # The checkpoint step each restarted attempt resumed from: a
        # kill_during_save run shows the step before the torn one here.
        "resumed_from": [r.get("step") for r in
                         events.read_events(event_path, "checkpoint_resume")],
        "final_loss": (final or {}).get("final_loss"),
    }
    timing = events.read_events(event_path, "step_timing")
    per_rank: dict = {}
    for rec in timing:
        per_rank.setdefault(int(rec.get("rank", 0)), []).append(
            float(rec.get("mean_step_s", 0.0)))
    report["telemetry"] = {
        "observe_dir": str(workdir / "observe"),
        "step_timing_events": len(timing),
        "per_rank_mean_step_s": {
            str(rank): round(sum(v) / len(v), 6)
            for rank, v in sorted(per_rank.items()) if v},
        "stragglers": [
            {k: rec.get(k) for k in ("epoch", "rank", "step_s",
                                     "median_s", "ratio")}
            for rec in events.read_events(event_path, "straggler_detected")],
    }
    ok = sup_report.success and bool(fired)
    if not fired:
        report["failure"] = "no fault fired — vacuous chaos run"
    if any(f.kind == "preempt" for f in plan.faults):
        preempted = any("preempted" in kinds
                        for kinds in sup_json["exit_kinds"])
        if not (preempted and drained):
            ok = False
            report["failure"] = (
                "preempt plan but no graceful drain observed "
                f"(preempted_exit={preempted}, drained={bool(drained)})")
    report["_ok"] = ok
    return report


def _integrity_gate(report: dict, event_path, sup_report) -> bool:
    """An integrity plan must have rolled back in the process, and not by
    a gang restart."""
    rollbacks = events.read_events(event_path, "integrity_rollback")
    anomalies = events.read_events(event_path, "integrity_anomaly")
    sdc = events.read_events(event_path, "integrity_sdc")
    report["integrity"] = {
        "anomalies": [{k: r.get(k) for k in ("kind", "step", "window")}
                      for r in anomalies],
        "rollbacks": [{k: r.get(k) for k in ("kind", "step", "restored_step",
                                             "next_epoch")}
                      for r in rollbacks],
        "sdc_detections": [{k: r.get(k) for k in ("step", "culprits")}
                           for r in sdc],
    }
    if not rollbacks:
        report["failure"] = ("integrity plan but no rollback-and-replay "
                             "happened — vacuous integrity run")
        return False
    if sup_report.restarts != 0:
        report["failure"] = (
            f"integrity recovery leaned on a gang restart "
            f"(restarts={sup_report.restarts}) instead of in-process "
            f"rollback-and-replay")
        return False
    return True


if __name__ == "__main__":
    sys.exit(main())
