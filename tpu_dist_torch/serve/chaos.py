"""Serve-path chaos: crash, stall and storm faults with anti-vacuity gates.

Counterpart of ``tpu_dist/serve/chaos.py``, reached through ``python -m
tpu_dist_torch.serve --chaos --plan ...``. Three fault kinds, the same
FaultPlan grammar and the same report:

* ``engine_crash@reqN`` / ``decode_stall@reqN[:Ss]`` run END TO END: an
  uninterrupted in-process **baseline** records every request's greedy
  token stream; then a :class:`~tpu_dist_torch.serve.supervisor.
  ServeSupervisor` runs the same workload as a ``--worker`` subprocess
  with the plan armed, the engine dies mid-decode (an injected
  ``os._exit``, or the stall watchdog exiting :data:`~tpu_dist_torch.
  resilience.faults.EXIT_SERVE_ABORT`), restarts, and REPLAYS the shared
  journal. Gates: the fault fired, the engine restarted, recovery went
  through a journal replay, and the per-request token streams read back
  from the journal equal the baseline's.
* ``request_storm@reqN`` runs in process on a :class:`VirtualClock`: the
  engine's ``virtual_step_s`` advances the clock per decode step, so
  queueing delay is measured in deterministic virtual seconds. A
  **shedding** run (bounded queue and projected-TTFT bound) must keep the
  admitted requests' p99 latency within the target while a **control**
  run without shedding must exceed it.

One rule differs from the reference, for the card: a recovered engine
batches requests in other buckets and re-prefills a replayed request
where the baseline decoded it, so on CUDA other matmul shapes can flip an
fp32 near-tie. A stream that leaves the baseline's where the full forward
ranks both tokens within :data:`TIE_GAP` of its best is a certified tie:
the report lists it under ``certified_ties`` and the parity gate lets it
pass; any other difference fails. On the CPU the streams are expected to
be exact (the tests hold ``certified_ties`` empty).

The report is JSON on stdout; exit 0 iff every gate passes, 2 when the
plan holds no serve fault.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from tpu_dist_torch.observe import metrics
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (FAULT_PLAN_ENV, FLEET_KINDS,
                                              SERVE_KINDS, FaultPlan,
                                              describe)
from tpu_dist_torch.serve.scheduler import DONE, EVICTED, SHED

#: Default p99 latency target (virtual seconds) for the storm gate when
#: ``BENCH_SERVE.json`` is not found at the repo root.
DEFAULT_P99_TARGET_S = 15.0

#: A stream may leave the baseline's only where the full forward's logits
#: of both tokens lie within this of its largest (a certified tie).
TIE_GAP = 1e-4


class VirtualClock:
    """A monotonic clock that only moves when told to. The storm gate
    injects it as the engine clock with ``virtual_step_s > 0``, making
    every submit/first-token/finish timestamp a function of the schedule
    rather than of host speed."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def bench_p99_target_s() -> float:
    """The serving p99 target from ``BENCH_SERVE.json``'s ``config`` (repo
    root), as the reference reads it, or the default when the file is
    missing or unparseable. It is a virtual-time target of the storm gate,
    not a measured time."""
    path = pathlib.Path(__file__).resolve().parents[2] / "BENCH_SERVE.json"
    try:
        cfg = json.loads(path.read_text()).get("config", {})
        return float(cfg.get("p99_target_s", DEFAULT_P99_TARGET_S))
    except (OSError, ValueError):
        return DEFAULT_P99_TARGET_S


# -- the supervised worker (one attempt of the chaos run) ---------------------


def run_worker(args) -> int:
    """``--worker`` mode: serve the seeded workload once, under whatever
    journal and fault-plan environment the supervisor armed.

    Resubmission is idempotent: workload index == request id (requests are
    submitted in order before any shedding), so any index the recovered
    journal already knows — finished, replayed or shed — is skipped; the
    journal replay owns those requests. The attempt's first token is
    logged as a ``serve_first_token`` event (the restart-to-first-token
    time of the chaos report); the result line adds the seconds spent
    capturing graphs and the longest step's, which size a stall timeout
    that healthy first calls stay under."""
    from tpu_dist_torch.resilience.injector import \
        maybe_serve_injector_from_env
    from tpu_dist_torch.serve import journal as journal_lib
    from tpu_dist_torch.serve.cli import _build_engine, _workload

    metrics.get_registry().reset()
    metrics.enable()
    jdir = journal_lib.journal_dir_from_env() or args.journal_dir
    engine = _build_engine(
        args, journal=jdir, max_queue=args.max_queue,
        max_ttft_s=args.max_ttft_s, retry_budget=args.retry_budget,
        stall_timeout_s=args.stall_timeout_s,
        fault_injector=maybe_serve_injector_from_env())
    skipped = 0
    for i, w in enumerate(_workload(args)):
        if i in engine.known_rids:
            skipped += 1
            continue
        engine.submit(w["prompt"], max_new_tokens=w["max_new_tokens"],
                      deadline_s=args.deadline_s)
    tokens = metrics.get_registry().counter("serve.tokens.generated")
    first_logged = False
    steps, max_step_s = 0, 0.0
    while not engine.scheduler.idle():
        t0 = time.monotonic()
        engine.step()
        max_step_s = max(max_step_s, time.monotonic() - t0)
        steps += 1
        if not first_logged and tokens.value > 0:
            events.maybe_log("serve_first_token",
                             attempt=events.current_attempt())
            first_logged = True
        if steps >= 100_000:
            raise RuntimeError("serve worker still busy after 100000 steps")
    engine.close()
    metrics.disable()
    by_status = {s: [r for r in engine.finished if r.status == s]
                 for s in (DONE, EVICTED, SHED)}
    result = {
        "attempt": events.current_attempt(),
        "completed": len(by_status[DONE]),
        "evicted": len(by_status[EVICTED]),
        "shed": len(by_status[SHED]),
        "resubmit_skipped": skipped,
        "replay": engine.last_replay,
        "capture_seconds": engine.capture_seconds,
        "max_step_s": max_step_s,
    }
    print("RESULT:" + json.dumps(result), flush=True)
    return 0 if result["completed"] > 0 else 1


# -- baseline (uninterrupted, in process) -------------------------------------


def baseline_token_streams(args) -> dict:
    """Serve the whole workload in process with no journal and no faults;
    returns ``{rid: [tokens...]}`` — the parity reference (greedy decode of
    a request does not depend on how it was batched)."""
    from tpu_dist_torch.serve.cli import _build_engine, _workload

    engine = _build_engine(args)
    reqs = [engine.submit(w["prompt"], max_new_tokens=w["max_new_tokens"])
            for w in _workload(args)]
    engine.run_until_idle()
    return {r.rid: list(r.generated) for r in reqs}


def _certified_tie(model, device, prompt: list, want: list,
                   got: list) -> Optional[int]:
    """The index where ``got`` leaves ``want`` if the full forward ranks
    both tokens there within :data:`TIE_GAP` of its best, else None."""
    import torch

    t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if t is None:
        return None
    with torch.inference_mode():
        seq = torch.tensor(prompt + want[:t], device=device)
        logits = model(seq[None])[0, -1].float()
    top = float(logits.max())
    if (top - float(logits[want[t]]) < TIE_GAP
            and top - float(logits[got[t]]) < TIE_GAP):
        return t
    return None


def _parity(args, baseline: dict, state) -> tuple[list, list]:
    """(mismatches, certified_ties) of the journal's streams against the
    baseline's. The model for the tie check is built only when a stream
    differs."""
    from tpu_dist_torch.serve.cli import _build_engine, _workload

    mismatches, ties = [], []
    engine = None
    workload = _workload(args)
    for rid, want in sorted(baseline.items()):
        jr = state.requests.get(rid)
        got = list(jr.tokens) if jr is not None else None
        if jr is not None and jr.finished and got == want:
            continue
        if jr is not None and jr.finished and len(got) == len(want):
            if engine is None:
                engine = _build_engine(args)
            t = _certified_tie(engine.model, engine.device,
                               workload[rid]["prompt"], want, got)
            if t is not None:
                ties.append({"rid": rid, "token": t, "expected": want[t],
                             "got": got[t]})
                continue
        mismatches.append({
            "rid": rid, "expected": want, "got": got,
            "finished": bool(jr is not None and jr.finished)})
    return mismatches, ties


# -- the storm gate (in process, virtual time) --------------------------------


def run_storm(args, *, shedding: bool, target_s: float) -> dict:
    """One storm run: ``--storm-requests`` chaff requests submitted in
    bursts between decode rounds, latency measured on the virtual clock.
    ``shedding`` arms the bounded queue and the projected-TTFT bound; the
    control run takes the whole storm and eats the queueing delay."""
    from tpu_dist_torch.serve.cli import _build_engine, _quantile

    clock = VirtualClock()
    max_queue = (args.max_queue if args.max_queue is not None
                 else 2 * args.max_batch) if shedding else None
    max_ttft = (args.max_ttft_s if args.max_ttft_s is not None
                else target_s / 2.0) if shedding else None
    engine = _build_engine(args, clock=clock,
                           virtual_step_s=args.virtual_step_s,
                           max_queue=max_queue, max_ttft_s=max_ttft)
    rng = np.random.default_rng(args.seed)
    n = args.storm_requests
    submitted = 0
    rounds = 0
    while submitted < n or not engine.scheduler.idle():
        burst = min(args.storm_burst, n - submitted)
        for _ in range(burst):
            plen = int(rng.integers(2, max(3, args.max_len // 4)))
            engine.submit(
                rng.integers(0, args.vocab, size=plen).tolist(),
                max_new_tokens=int(rng.integers(args.min_new,
                                                args.max_new + 1)))
            submitted += 1
        engine.step()
        rounds += 1
        if rounds > 100 * n:
            raise RuntimeError("storm run failed to drain")
    done = [r for r in engine.finished if r.status == DONE]
    shed = [r for r in engine.finished if r.status == SHED]
    lat = [r.latency_s for r in done if r.latency_s is not None]
    return {
        "mode": "shedding" if shedding else "control",
        "requests": n,
        "completed": len(done),
        "shed": len(shed),
        "shed_causes": sorted({r.shed_cause for r in shed
                               if r.shed_cause is not None}),
        "p99_latency_virtual_s": _quantile(lat, 0.99),
        "virtual_makespan_s": round(clock.t, 6),
        "decode_rounds": rounds,
    }


# -- the chaos runner ---------------------------------------------------------


def _worker_cmd(args, *, stall_timeout_s: Optional[float]) -> list:
    cmd = [sys.executable, "-m", "tpu_dist_torch.serve", "--worker",
           "--requests", str(args.requests),
           "--max-batch", str(args.max_batch),
           "--max-len", str(args.max_len),
           "--min-new", str(args.min_new),
           "--max-new", str(args.max_new),
           "--vocab", str(args.vocab),
           "--d-model", str(args.d_model),
           "--depth", str(args.depth),
           "--num-heads", str(args.num_heads),
           "--seed", str(args.seed)]
    if args.device is not None:
        cmd += ["--device", args.device]
    if args.model_dir:
        cmd += ["--model-dir", args.model_dir]
    if stall_timeout_s is not None:
        cmd += ["--stall-timeout-s", str(stall_timeout_s)]
    if args.retry_budget is not None:
        cmd += ["--retry-budget", str(args.retry_budget)]
    return cmd


def _clean_env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in (FAULT_PLAN_ENV, events.EVENT_LOG_ENV,
                        events.ATTEMPT_ENV)
           and not k.startswith("TPU_DIST_SERVE")}
    env.update(extra)
    return env


def _restart_to_first_token(event_path) -> list:
    """Seconds from each ``restart`` the supervisor logged to the first
    token of the attempt it started."""
    firsts = {e.get("attempt"): e["ts"] for e in
              events.read_events(event_path, "serve_first_token")}
    return [round(firsts[e["attempt"]] - e["ts"], 6)
            for e in events.read_events(event_path, "restart")
            if e.get("attempt") in firsts]


def run_chaos(args) -> int:
    """``--chaos`` mode: run the plan's serve faults, print the gated JSON
    report, exit 0 iff every gate holds."""
    from tpu_dist_torch.serve.supervisor import ServeSupervisor

    if args.temperature != 0.0:
        print("error: --chaos requires greedy decoding (--temperature 0); "
              "the token-parity gate is a greedy guarantee", file=sys.stderr)
        return 2
    plan = FaultPlan.parse(args.plan) if args.plan else None
    fleet_faults = ([f for f in plan.faults if f.kind in FLEET_KINDS]
                    if plan else [])
    if fleet_faults:
        print(f"error: fault kind(s) "
              f"{sorted({f.kind for f in fleet_faults})} target the fleet "
              f"router; run them through --fleet, not --chaos",
              file=sys.stderr)
        return 2
    serve_faults = ([f for f in plan.faults if f.kind in SERVE_KINDS]
                    if plan else [])
    if not serve_faults:
        print("error: --chaos needs --plan with at least one serve fault "
              "(engine_crash@reqN / decode_stall@reqN / request_storm@reqN)",
              file=sys.stderr)
        return 2
    engine_faults = [f for f in serve_faults if f.kind != "request_storm"]
    storm_faults = [f for f in serve_faults if f.kind == "request_storm"]
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
        prefix="tpu-dist-serve-chaos-"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"serve chaos workdir: {workdir}", file=sys.stderr)
    for line in describe(plan):
        print(f"fault: {line}", file=sys.stderr)

    report: dict = {"plan": plan.to_json(), "workdir": str(workdir)}
    ok = True

    if engine_faults:
        # Arm the stall watchdog whenever the plan stalls a decode step:
        # the watchdog, not the injector, turns the hang into a classified
        # restartable exit.
        stall_to = args.stall_timeout_s
        if stall_to is None and any(f.kind == "decode_stall"
                                    for f in engine_faults):
            stall_to = 1.0

        print("running baseline (uninterrupted, in process)...",
              file=sys.stderr)
        baseline = baseline_token_streams(args)

        print("running supervised chaos serve...", file=sys.stderr)
        event_path = workdir / "events.jsonl"
        sup = ServeSupervisor(
            _worker_cmd(args, stall_timeout_s=stall_to),
            journal_dir=workdir / "journal",
            max_restarts=args.max_restarts,
            attempt_deadline_s=args.deadline,
            env=_clean_env({FAULT_PLAN_ENV: plan.dumps(),
                            events.EVENT_LOG_ENV: str(event_path)}),
            log_dir=workdir / "logs",
            event_log=events.EventLog(event_path, role="supervisor"))
        t0 = time.monotonic()
        sup_report = sup.run()
        final = sup.final_result(sup_report)
        state = sup.journal_state()
        fired = events.read_events(event_path, "fault_fired")
        sup_json = sup_report.to_json()
        mismatches, ties = _parity(args, baseline, state)
        replays = state.replay_markers
        report["engine"] = {
            "success": sup_report.success,
            "attempts": sup_report.attempts,
            "restarts": sup_report.restarts,
            "exit_codes": [o.exit_codes for o in sup_report.outcomes],
            "exit_kinds": sup_json["exit_kinds"],
            "wall_time_s": round(time.monotonic() - t0, 3),
            "faults_fired": [
                {k: r.get(k) for k in ("kind", "req", "done", "seconds")
                 if r.get(k) is not None} for r in fired],
            "journal_records": state.records,
            "journal_replays": [
                {k: m.get(k) for k in ("attempt", "active", "queued",
                                       "completed", "replay_s")}
                for m in replays],
            "restart_to_first_token_s": _restart_to_first_token(event_path),
            "final_result": final,
            "baseline_requests": len(baseline),
            "token_mismatches": mismatches,
            "certified_ties": ties,
        }
        if not sup_report.success:
            ok = False
            report["failure"] = "supervised serve run did not succeed"
        elif not fired:
            ok = False
            report["failure"] = "no fault fired — vacuous chaos run"
        elif sup_report.restarts < 1:
            ok = False
            report["failure"] = ("engine fault plan but the engine never "
                                 "restarted — vacuous chaos run")
        elif not replays:
            ok = False
            report["failure"] = (
                "engine restarted without a journal replay — the restart "
                "served from scratch (silent request loss, not recovery)")
        elif mismatches:
            ok = False
            report["failure"] = (
                f"token parity violated for {len(mismatches)} request(s)")
        else:
            report["engine"]["parity_ok"] = True

    if storm_faults:
        target = (args.p99_target_s if args.p99_target_s is not None
                  else bench_p99_target_s())
        print(f"running request storm (shedding vs control, p99 target "
              f"{target}s virtual)...", file=sys.stderr)
        shed_run = run_storm(args, shedding=True, target_s=target)
        control = run_storm(args, shedding=False, target_s=target)
        report["storm"] = {"p99_target_s": target,
                           "shedding": shed_run, "control": control}
        sp99, cp99 = (shed_run["p99_latency_virtual_s"],
                      control["p99_latency_virtual_s"])
        if shed_run["shed"] <= 0:
            ok = False
            report["failure"] = ("storm run shed nothing — overload "
                                 "protection never engaged (vacuous)")
        elif sp99 is None or sp99 > target:
            ok = False
            report["failure"] = (
                f"admitted-request p99 {sp99}s blew the {target}s target "
                f"despite shedding")
        elif cp99 is not None and cp99 <= target:
            ok = False
            report["failure"] = (
                f"no-shedding control p99 {cp99}s met the target anyway — "
                f"the storm is too small to prove shedding matters")
        else:
            report["storm"]["ok"] = True

    report["ok"] = ok
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    return 0 if ok else 1
