"""``python -m tpu_dist_torch.resilience --ps-chaos``: chaos legs for the
asynchronous parameter-server execution model.

Counterpart of ``tpu_dist/resilience/ps_chaos.py``, with the same legs and
gates; ``--device`` (CUDA unless ``cpu``) is handed to every process.

The sync stack's chaos story is gang-shaped: kill a rank, watch the gang
reform/restart, gate on exact loss parity. The PS model breaks every one of
those assumptions on purpose, so its chaos legs gate on what the model
actually promises:

* **straggler**: a worker delayed to ~10x its measured step time costs the
  async server <10% apply throughput — while the measured gang-synchronous
  control (``TPU_DIST_PS_SYNC=1``, every round waits for every rank)
  collapses. The delay is calibrated per run from the clean async leg, not
  hardcoded, so the 10x is honest on any host.
* **kill-worker**: a fault-killed worker is a NON-EVENT — zero supervisor
  restarts anywhere, the server still reaches its full apply budget on the
  survivors, and the final loss converges within tolerance.
* **server-kill**: the server IS a single point of state, so its death
  restores from the async checkpointer's last published step, re-applies
  the still-on-disk packets past it, and completes the budget.

Every leg is anti-vacuous: a leg armed with a fault plan FAILS unless a
``fault_fired`` event proves the fault actually fired.

Topology per leg: one server under the ordinary
:class:`~tpu_dist_torch.resilience.supervisor.Supervisor` (restarts allowed
only in the server-kill leg) + N workers as raw child processes that nothing
supervises — worker death being free is the claim under test, so the
harness must not quietly re-launch them.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time
from typing import Optional

from tpu_dist_torch.cluster import ps_transport
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.entrypoints import (CHECKPOINT_DIR_ENV,
                                                   ENTRY_ENV)
from tpu_dist_torch.resilience.faults import (EXIT_FAULT_KILL,
                                              FAULT_PLAN_ENV)

_SERVER_ENTRY = "tpu_dist_torch.resilience.entrypoints:demo_ps_server"
_WORKER_ENTRY = "tpu_dist_torch.resilience.entrypoints:demo_ps_worker"

#: Default bounded-staleness window for the chaos legs (also the knob the
#: README documents): small enough that convergence is bounded-staleness,
#: large enough that a straggler doesn't throttle the fast workers.
LEG_STALENESS = 4


def run_ps_leg(leg_dir: pathlib.Path, *, world: int, epochs: int,
               steps: int, batch: int, staleness: int = LEG_STALENESS,
               sync: bool = False, budget: Optional[int] = None,
               worker_plans: Optional[dict] = None,
               server_plan: Optional[str] = None,
               server_max_restarts: int = 0, ckpt_every: int = 8,
               deadline: float = 300.0, pull_timeout: float = 120.0,
               retain_grads: bool = False,
               device: Optional[str] = None) -> dict:
    """One PS session: a supervised server + ``world`` unsupervised
    workers, all sharing one PSDir and one event log, each process on
    ``device``. Returns the leg record the gates read."""
    from tpu_dist_torch.resilience.cli import (_clean_env, _worker_cmd,
                                               parse_result_line)
    from tpu_dist_torch.resilience.supervisor import (BackoffPolicy,
                                                      Supervisor)

    leg_dir.mkdir(parents=True, exist_ok=True)
    event_path = leg_dir / "events.jsonl"
    common = {
        ps_transport.PS_DIR_ENV: str(leg_dir / "ps"),
        ps_transport.PS_WORLD_ENV: str(world),
        ps_transport.PS_STALENESS_ENV: str(staleness),
        ps_transport.PS_SYNC_ENV: "1" if sync else "0",
        ps_transport.PS_PULL_TIMEOUT_ENV: str(pull_timeout),
        "TPU_DIST_DEMO_EPOCHS": str(epochs),
        "TPU_DIST_DEMO_STEPS_PER_EPOCH": str(steps),
        "TPU_DIST_DEMO_BATCH": str(batch),
        events.EVENT_LOG_ENV: str(event_path),
    }
    if budget is not None:
        common["TPU_DIST_PS_BUDGET"] = str(budget)

    # Workers first (raw Popen, NEVER restarted): they block in pull until
    # the server's first publish, so worker-before-server is race-free.
    procs, worker_logs, handles = [], [], []
    try:
        for r in range(world):
            wenv = _clean_env({
                **common,
                ENTRY_ENV: _WORKER_ENTRY,
                ps_transport.PS_ROLE_ENV: "worker",
                ps_transport.PS_RANK_ENV: str(r),
                # The injector resolves its rank through the rejoin-rank
                # seam in single-process mode; PS reuses it so one fault
                # grammar (`:rankN`) addresses both execution models.
                "TPU_DIST_REJOIN_RANK": str(r),
            })
            plan = (worker_plans or {}).get(r)
            if plan:
                wenv[FAULT_PLAN_ENV] = plan
            log_path = leg_dir / f"worker{r}.log"
            worker_logs.append(log_path)
            fh = open(log_path, "wb")
            handles.append(fh)
            procs.append(subprocess.Popen(
                _worker_cmd(device), env=wenv, stdout=fh,
                stderr=subprocess.STDOUT))

        server_extra = {
            **common,
            ENTRY_ENV: _SERVER_ENTRY,
            ps_transport.PS_ROLE_ENV: "server",
            # The server's fault-target rank is `world` — one past the
            # worker ranks, so `kill@stepN:rank<world>` can never address
            # a worker by accident.
            ps_transport.PS_RANK_ENV: str(world),
            CHECKPOINT_DIR_ENV: str(leg_dir / "ckpt"),
            "TPU_DIST_PS_CKPT_EVERY": str(ckpt_every),
        }
        if retain_grads:
            server_extra["TPU_DIST_PS_RETAIN_GRADS"] = "1"
        if server_plan:
            server_extra[FAULT_PLAN_ENV] = server_plan
        sup = Supervisor(
            _worker_cmd(device), num_workers=1,
            max_restarts=server_max_restarts,
            attempt_deadline_s=deadline,
            backoff=BackoffPolicy(initial_s=0.2),
            env=_clean_env(server_extra),
            log_dir=leg_dir / "server-logs",
            event_log=events.EventLog(event_path, role="supervisor"))
        t0 = time.perf_counter()
        sup_report = sup.run()
        # Server is done (STOP on disk) — workers exit at their next pull.
        worker_rcs = []
        for p in procs:
            try:
                worker_rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                worker_rcs.append(None)  # wedged: reaped, reported as None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for fh in handles:
            fh.close()

    server_result = None
    if sup_report.success:
        server_result = parse_result_line(sup.worker_log(
            sup_report.attempts - 1, 0).read_text(errors="replace"))
    worker_results = [parse_result_line(lp.read_text(errors="replace"))
                      for lp in worker_logs]
    fired = events.read_events(event_path, "fault_fired")
    restores = events.read_events(event_path, "ps_server_restore")
    return {
        "dir": str(leg_dir),
        "sync": sync,
        "ok": bool(sup_report.success and server_result),
        "wall_s": round(time.perf_counter() - t0, 3),
        "server": server_result,
        "server_restarts": sup_report.restarts,
        "server_attempts": sup_report.attempts,
        "worker_exit_codes": worker_rcs,
        "worker_pushes": [None if r is None else r.get("pushes")
                          for r in worker_results],
        "throughput_sps": (server_result or {}).get("throughput_sps"),
        "final_loss": (server_result or {}).get("final_loss"),
        "applies": (server_result or {}).get("applies"),
        "applied_by_rank": (server_result or {}).get("applied_by_rank"),
        "faults_fired": len(fired),
        "fault_kinds": sorted({r.get("kind") for r in fired
                               if r.get("kind")}),
        "server_restores": [r.get("step") for r in restores],
    }


def _gate(failures: list, ok: bool, message: str) -> bool:
    if not ok:
        failures.append(message)
    return ok


def run_ps_chaos(args, workdir: pathlib.Path) -> int:
    """The full experiment; returns the process exit code (0 = all gates
    hold). Leg selection via ``--ps-legs`` (``straggler``, ``kill``,
    ``server``, ``sync``); the default ``all`` runs every leg, the sync
    control pair included."""
    import json

    world = max(2, int(args.ps_world))
    epochs, steps = int(args.ps_epochs), int(args.ps_steps)
    batch = int(args.ps_batch)
    staleness = int(args.ps_staleness)
    tol = float(args.ps_tol)
    budget = epochs * steps * world
    selected = {s.strip() for s in (args.ps_legs or "all").split(",")
                if s.strip()}
    run_sync = "all" in selected or "sync" in selected
    run_server_kill = "all" in selected or "server" in selected
    run_kill = "all" in selected or "kill" in selected
    run_straggler = "all" in selected or "straggler" in selected

    cfg = dict(world=world, epochs=epochs, steps=steps, batch=batch,
               staleness=staleness, budget=budget, deadline=args.deadline,
               device=args.device)
    leg_kw = dict(world=world, epochs=epochs, steps=steps, batch=batch,
                  staleness=staleness, budget=budget,
                  deadline=args.deadline, device=args.device)
    report: dict = {"mode": "ps_chaos", "workdir": str(workdir),
                    "config": cfg, "legs": {}}
    failures: list = []

    # Leg 1 — clean async: the throughput reference AND the per-run
    # straggler-delay calibration (10x the measured per-worker step time).
    print("ps-chaos: clean async leg...", file=sys.stderr)
    clean = run_ps_leg(workdir / "clean_async", **leg_kw)
    report["legs"]["clean_async"] = clean
    _gate(failures, clean["ok"], "clean_async leg failed")
    tput = clean.get("throughput_sps") or 0.0
    _gate(failures, tput > 0, "clean_async measured no throughput")
    step_s = world / tput if tput else 0.2
    delay_s = max(0.05, round(9.0 * step_s, 3))
    straggler_plan = f"delay@step*:rank1:always:{delay_s}s"
    report["straggler"] = {"delay_s": delay_s,
                           "clean_step_s": round(step_s, 4),
                           "plan": straggler_plan}

    if run_straggler:
        # Leg 2 — async under a permanent 10x straggler on rank 1: the
        # budget must still flow at >=90% of the clean apply rate (the
        # fast workers cover what the straggler doesn't push).
        print(f"ps-chaos: straggler async leg (delay {delay_s}s)...",
              file=sys.stderr)
        strag = run_ps_leg(workdir / "straggler_async",
                           worker_plans={1: straggler_plan}, **leg_kw)
        report["legs"]["straggler_async"] = strag
        _gate(failures, strag["ok"], "straggler_async leg failed")
        _gate(failures, strag["faults_fired"] > 0,
              "straggler_async: no fault fired — vacuous leg")
        s_tput = strag.get("throughput_sps") or 0.0
        ratio = round(s_tput / tput, 4) if tput else 0.0
        report["straggler"]["async_throughput_ratio"] = ratio
        _gate(failures, ratio >= 0.9,
              f"straggler cost async throughput too much "
              f"(ratio {ratio} < 0.9)")

    if run_sync:
        # Legs 3+4 — the measured sync control: same budget, same
        # straggler, gang-synchronous rounds. Collapse is MEASURED, not
        # assumed.
        print("ps-chaos: clean sync control leg...", file=sys.stderr)
        sync_clean = run_ps_leg(workdir / "clean_sync", sync=True, **leg_kw)
        report["legs"]["clean_sync"] = sync_clean
        _gate(failures, sync_clean["ok"], "clean_sync leg failed")
        print("ps-chaos: straggler sync control leg...", file=sys.stderr)
        sync_strag = run_ps_leg(workdir / "straggler_sync", sync=True,
                                worker_plans={1: straggler_plan}, **leg_kw)
        report["legs"]["straggler_sync"] = sync_strag
        _gate(failures, sync_strag["ok"], "straggler_sync leg failed")
        _gate(failures, sync_strag["faults_fired"] > 0,
              "straggler_sync: no fault fired — vacuous leg")
        c, s = (sync_clean.get("throughput_sps") or 0.0,
                sync_strag.get("throughput_sps") or 0.0)
        sync_ratio = round(s / c, 4) if c else 1.0
        report["straggler"]["sync_throughput_ratio"] = sync_ratio
        _gate(failures, sync_ratio < 0.5,
              f"sync control did not collapse under the straggler "
              f"(ratio {sync_ratio} >= 0.5)")
        # Bounded-staleness convergence: async final loss within tolerance
        # of the sync control on the same budget/data.
        a, b = clean.get("final_loss"), sync_clean.get("final_loss")
        if a is None or b is None:
            failures.append("missing final loss for the convergence gate")
        else:
            delta = round(abs(a - b), 6)
            report["convergence"] = {"async_final_loss": a,
                                     "sync_final_loss": b,
                                     "delta": delta, "tol": tol}
            _gate(failures, delta <= tol,
                  f"async final loss {a} not within {tol} of sync "
                  f"control {b} (delta {delta})")

    if run_kill:
        # Leg 5 — kill-worker: rank 1 dies mid-run; ZERO restarts
        # anywhere, the server still completes the FULL budget, and the
        # final loss stays within tolerance of the clean reference.
        kill_step = max(2, (budget // world) // 2)
        print(f"ps-chaos: kill-worker leg (kill rank 1 at local step "
              f"{kill_step})...", file=sys.stderr)
        killw = run_ps_leg(workdir / "kill_worker",
                           worker_plans={1: f"kill@step{kill_step}:rank1"},
                           **leg_kw)
        report["legs"]["kill_worker"] = killw
        _gate(failures, killw["ok"], "kill_worker leg failed")
        _gate(failures, killw["faults_fired"] > 0,
              "kill_worker: no fault fired — vacuous leg")
        _gate(failures, killw["server_restarts"] == 0,
              f"kill_worker: server restarted "
              f"{killw['server_restarts']}x — worker death must be free")
        _gate(failures,
              killw["worker_exit_codes"][1:2] == [EXIT_FAULT_KILL],
              f"kill_worker: rank 1 exited "
              f"{killw['worker_exit_codes'][1:2]}, expected fault-kill "
              f"{EXIT_FAULT_KILL}")
        _gate(failures, killw.get("applies") == budget,
              f"kill_worker: server applied {killw.get('applies')} of "
              f"budget {budget} — the survivors did not cover the dead "
              "worker")
        ref = clean.get("final_loss")
        kfl = killw.get("final_loss")
        if ref is not None and kfl is not None:
            kd = round(abs(kfl - ref), 6)
            report["legs"]["kill_worker"]["loss_delta_vs_clean"] = kd
            _gate(failures, kd <= tol,
                  f"kill_worker final loss {kfl} not within {tol} of "
                  f"clean async {ref} (delta {kd})")

    if run_server_kill:
        # Leg 6 — server-kill: the server dies mid-budget, the Supervisor
        # relaunches it, and it must RESTORE from the async checkpointer's
        # last published step (proved by ps_server_restore + a non-null
        # restored_from), re-apply surviving packets, and finish.
        ckpt_every = max(2, budget // 4)
        kill_at = min(budget - 2, ckpt_every + max(2, budget // 4))
        print(f"ps-chaos: server-kill leg (kill server at apply "
              f"{kill_at})...", file=sys.stderr)
        skill = run_ps_leg(
            workdir / "server_kill",
            server_plan=f"kill@step{kill_at}:rank{world}",
            server_max_restarts=2, ckpt_every=ckpt_every, **leg_kw)
        report["legs"]["server_kill"] = skill
        _gate(failures, skill["ok"], "server_kill leg failed")
        _gate(failures, skill["faults_fired"] > 0,
              "server_kill: no fault fired — vacuous leg")
        _gate(failures, skill["server_restarts"] >= 1,
              "server_kill: the server never restarted")
        _gate(failures, bool(skill["server_restores"]),
              "server_kill: no ps_server_restore — the restart did not "
              "restore from the published checkpoint")
        restored = (skill.get("server") or {}).get("restored_from")
        _gate(failures, restored is not None and restored > 0,
              f"server_kill: restarted server restored from "
              f"{restored!r}, expected a positive published step")
        _gate(failures, skill.get("applies") == budget,
              f"server_kill: completed {skill.get('applies')} of budget "
              f"{budget} after restore")

    report["ok"] = not failures
    if failures:
        report["failure"] = "; ".join(failures)
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    return 0 if not failures else 1
