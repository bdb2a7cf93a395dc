"""FaultPlan: a declarative, deterministic chaos specification.

Counterpart of ``tpu_dist/resilience/faults.py``, copied whole (the port
imports nothing of ``tpu_dist``): the grammar, the kinds, the registered
exit codes and the JSON form are the reference's, so a plan written for
either package arms the other. The port's serve engine arms the serve
kinds (:class:`~tpu_dist_torch.resilience.injector.ServeFaultInjector`),
``fit`` the training kinds (:class:`~tpu_dist_torch.resilience.injector.
FaultInjector`), the job kinds too, in the ``fit`` of a packed job's
worker (``jobs/``), whose ``$TPU_DIST_JOB_INDEX`` selects them.

A plan is a list of :class:`FaultSpec` entries, each naming *what* breaks
(``kind``), *where* (worker ``rank``), *when* (global optimizer ``step`` or
``epoch``, the serve request ``req`` or the packed ``job``, and the
supervisor restart ``attempt``), and kind-specific knobs. Plans come from
JSON (a file, an inline string, or the ``TPU_DIST_FAULT_PLAN`` environment
variable) or from the compact spec grammar used on the CLI::

    kill-worker@step5              # kill rank 0 at global step 5, attempt 0
    kill@step5:rank1               # same, but rank 1
    ckpt-fail@epoch0:truncate      # corrupt the epoch-0 checkpoint write
    ckpt-fail@epoch1:x2            # fail the next 2 checkpoint writes
    delay-collective@step3:0.5s    # stall host-level collectives 0.5 s
    delay@step*:rank1:always:2.5s  # rank 1 stalls EVERY step, every attempt
    hang-collective@step4:rank0    # stall them until the attempt deadline
    slow-input@step2:0.25s:x4      # slow the input pipeline for 4 steps
    nan_loss@step5                 # poison the step-5 batch with NaN
    grad_spike@step5               # scale the step-5 batch into a grad spike
    bitflip@step9:rank1            # flip one param bit on replica/rank 1
    bitflip@step9:leaf2:replica5   # flip a bit in leaf 2's shard on device 5
    corrupt_batch@step5            # garbage the step-5 batch (finite, huge)
    engine_crash@req4              # kill the serve engine at the 4th completion
    decode_stall@req2:2s           # hang a decode step 2 s mid-serve
    request_storm@req0:x400        # 400-request burst at submission 0
    replica_kill@req2:replica0     # kill fleet replica 0 at its 2nd completion
    router_storm@req0:x64          # 64-request burst through the fleet router
    job_kill@job1                  # kill job 1's worker at its step 1
    job_kill@job1:abort            # same, exiting EXIT_JOB_ABORT (abandon)
    job_hang@job0:5s:step2         # hang job 0's worker 5 s at its step 2

Multiple specs join with commas. Determinism is the design center: a fault
fires at exactly one (rank, attempt, step/epoch) coordinate, so a chaos run
is reproducible and its report comparable across commits. By default a fault
arms only on ``attempt`` 0 — the first launch — so the supervised *restart*
of the same program does not re-kill itself forever; set ``"attempt": null``
in JSON for a fault that fires on every attempt.

Fault kinds (the module paths below are the reference's; the port's serve
dispatch is :mod:`tpu_dist_torch.resilience.injector`):

``kill``
    ``os._exit(exit_code)`` at the target step — a hard worker death with no
    Python cleanup, the ungraceful-preemption analog.
``preempt``
    ``os.kill(os.getpid(), SIGTERM)`` at the target step — the GRACEFUL
    preemption: the real signal is delivered, so the worker's SIGTERM seam
    (:mod:`tpu_dist.resilience.entrypoints`) runs the production drain path
    — stop at the next step boundary, publish any in-flight checkpoint,
    exit :data:`EXIT_PREEMPTED`. Chaos plans use this to prove a preempted
    worker publishes before dying.
``delay_collective`` / ``hang_collective``
    Sleep inside the host-level collective seam
    (:func:`tpu_dist.parallel.collectives.install_fault_hook`) — barriers,
    chief broadcasts and host reductions stall as if the fabric did.
``checkpoint_fail``
    Transiently fail (``mode="transient"``) or corrupt (``mode="truncate"``)
    checkpoint writes through the seam in
    :mod:`tpu_dist.training.checkpoint`.
``kill_during_save``
    ``os._exit(exit_code)`` from inside the checkpoint write seam — the
    process dies with a checkpoint staged but NOT yet published. With the
    async pipeline the seam fires on the background writer thread while
    training is mid-epoch, so this is the deterministic "preempted during an
    in-flight async save" scenario: recovery must come from the last
    *published* step, never the torn stage. Targets the CHECKPOINT's step
    coordinate (``@epochN`` for ModelCheckpoint's per-epoch saves).
``slow_input``
    Sleep at host batch boundaries — a straggling input pipeline.
``nan_loss`` / ``grad_spike`` / ``corrupt_batch``
    SEMANTIC faults: corrupt the target step's batch through the trainer's
    batch seam (:func:`tpu_dist.training.integrity.install_batch_fault_hook`)
    so the *training math* goes wrong while every process stays alive —
    ``nan_loss`` poisons the batch with NaN, ``grad_spike`` scales it into a
    gradient explosion, ``corrupt_batch`` replaces it with finite garbage.
    Detected by the in-step health vector
    (:mod:`tpu_dist.training.integrity`), recovered by rollback-and-replay —
    no process exit, no gang restart.
``bitflip``
    Silent data corruption: flip one mantissa bit of one parameter leaf on
    one device (``:rankR`` = the replica/rank index; in single-process
    multi-device runs it names the local replica). Leaf- and
    shard-addressable: ``:leafK`` picks parameter leaf K (flatten order,
    default 0) and ``:replicaR`` the device position R — so a plan can
    corrupt exactly one shard of a TP-sharded kernel
    (``bitflip@step9:leaf2:replica5``). The flip is dtype-aware (bf16
    flips a top-mantissa bit, not a numerically invisible low byte bit).
    Nothing crashes and the loss stays plausible — only the SDC audit's
    shard-group checksum compare can see it.
``engine_crash`` / ``decode_stall`` / ``request_storm``
    SERVE-path faults, addressed by the request coordinate ``@reqN``
    instead of a training step (dispatch lives in the port's
    :class:`~tpu_dist_torch.resilience.injector.ServeFaultInjector`,
    armed by the serve worker/engine seams). ``engine_crash`` is
    ``os._exit(exit_code)`` at the decode-step boundary once N requests
    have completed — a mid-decode engine death whose recovery must come
    from the request journal;
    ``decode_stall`` sleeps ``:Ss`` seconds inside the decode window so the
    engine's stall watchdog (not a wedged event loop) must classify the
    hang as a fault; ``request_storm`` injects ``:xM`` extra burst requests
    into the load generator at submission index N, the overload that load
    shedding must absorb.
``replica_kill`` / ``router_storm``
    FLEET faults, addressed by ``@reqN`` like the serve kinds but armed
    only by the multi-replica router (:mod:`tpu_dist.serve.fleet`) — a
    solo engine's ``ServeFaultInjector`` never arms them, so a fleet plan
    reaching a solo run is inert by construction. ``replica_kill`` kills
    ONE replica worker (``:replicaR`` picks which, default 0) at that
    replica's N-th completed request, in-process at the decode-step
    boundary BEFORE the journal flush — the unflushed tail is genuinely
    lost, and the router must recover the dead replica's in-flight work
    from its on-disk journal onto the survivors. ``router_storm`` injects
    ``:xM`` extra burst requests at router submission index N — the
    fleet-level overload that per-replica admission control must shed
    without wedging the router.
``job_kill`` / ``job_hang``
    MULTI-JOB faults, addressed by the job coordinate ``@jobN`` — the
    submission index a :class:`~tpu_dist.jobs.scheduler.JobPool` assigns
    each packed job. The SAME plan is handed to every job's worker gang;
    each worker arms only the faults whose job index matches its own
    (``$TPU_DIST_JOB_INDEX``), so a fault in job N is invisible to its
    submesh neighbors — the per-job fault-domain contract the blast-radius
    gate pins. ``job_kill`` is ``os._exit`` at the job's own step
    coordinate (``:stepN`` modifier, default step 1; ``:abort`` exits
    :data:`EXIT_JOB_ABORT` so the job's supervisor abandons instead of
    restarting); ``job_hang`` sleeps ``:Ss`` seconds there, the straggler
    the per-job attempt deadline must absorb without touching neighbors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Sequence

#: Canonical fault kinds. CLI aliases (kill-worker, ckpt-fail, ...) normalize
#: onto these names.
KINDS = ("kill", "preempt", "delay_collective", "hang_collective",
         "checkpoint_fail", "kill_during_save", "slow_input",
         "nan_loss", "grad_spike", "bitflip", "corrupt_batch",
         "engine_crash", "decode_stall", "request_storm",
         "replica_kill", "router_storm",
         "job_kill", "job_hang")

#: Fault kinds that target the SERVING path; they address the request
#: coordinate (``@reqN``) instead of a training step/epoch.
SERVE_KINDS = frozenset({"engine_crash", "decode_stall", "request_storm",
                         "replica_kill", "router_storm"})

#: The subset of serve kinds only a MULTI-REPLICA fleet router arms
#: (:mod:`tpu_dist.serve.fleet`). A solo engine's ServeFaultInjector
#: never matches these, and the single-engine chaos run rejects plans
#: containing them — a fleet fault must never silently no-op in a solo
#: run and report a vacuous pass.
FLEET_KINDS = frozenset({"replica_kill", "router_storm"})

#: Fault kinds that target ONE JOB of a packed multi-job pool; they carry
#: the job coordinate (``@jobN``) and are armed only by workers whose
#: ``$TPU_DIST_JOB_INDEX`` matches — the per-job fault-domain boundary.
JOB_KINDS = frozenset({"job_kill", "job_hang"})

_ALIASES = {
    "kill-worker": "kill",
    "kill_worker": "kill",
    "preempt-worker": "preempt",
    "preempt_worker": "preempt",
    "sigterm": "preempt",
    "delay-collective": "delay_collective",
    "delay": "delay_collective",
    "hang-collective": "hang_collective",
    "ckpt-fail": "checkpoint_fail",
    "ckpt_fail": "checkpoint_fail",
    "checkpoint-fail": "checkpoint_fail",
    "kill-during-save": "kill_during_save",
    "ckpt-kill": "kill_during_save",
    "slow-input": "slow_input",
    "nan-loss": "nan_loss",
    "grad-spike": "grad_spike",
    "bit-flip": "bitflip",
    "corrupt-batch": "corrupt_batch",
    "engine-crash": "engine_crash",
    "decode-stall": "decode_stall",
    "request-storm": "request_storm",
    "replica-kill": "replica_kill",
    "router-storm": "router_storm",
    "job-kill": "job_kill",
    "job-hang": "job_hang",
}

#: Firing count carried by the ``@step*`` wildcard target: large enough to
#: never exhaust in any real run, finite so the injector's per-fault
#: remaining-count bookkeeping stays an int decrement like every other kind.
WILDCARD_COUNT = 1_000_000_000

#: Environment variable a worker reads its plan from (set by the CLI /
#: Supervisor; also settable by hand for code-edit-free chaos runs).
FAULT_PLAN_ENV = "TPU_DIST_FAULT_PLAN"

#: Exit code of a fault-killed worker — distinguishable from crashes (1) and
#: from PeerUnavailableError surrender (EXIT_PEER_UNAVAILABLE).
EXIT_FAULT_KILL = 43

#: Exit code of a worker that surrendered after detecting a dead peer
#: (liveness verdict) — the supervisor restarts these, they are victims.
EXIT_PEER_UNAVAILABLE = 17

#: Exit code of a worker that received SIGTERM and completed the graceful
#: drain — stopped at a step boundary with every in-flight checkpoint
#: published. Nonzero on purpose: a preempted worker did NOT finish its
#: training run, so the supervisor must restart the gang (possibly at a
#: different size); it is merely a *clean* restart, distinguishable from
#: ``fault_kill``/``signal_N`` in ``Supervisor.classify_exit``.
EXIT_PREEMPTED = 19

#: Exit code of a worker whose training-integrity guard exhausted its
#: rollback budget — repeated semantic anomalies (NaN loss, grad spikes,
#: replica SDC) that rollback-and-replay could not clear. Distinct from
#: ``fault_kill``/``preempted``: restarting the gang will NOT help (the
#: anomaly is in the data/hardware, not the process), so the supervisor
#: classifies it ``integrity_abort`` and operators triage instead of
#: burning restart budget.
EXIT_INTEGRITY = 41

#: Exit code of a serve engine that classified its own death — today the
#: decode-stall watchdog converting a hung decode step into a fault instead
#: of blocking the serving loop forever. Unlike ``integrity_abort`` this IS
#: restartable: a wedged device op is cured by a fresh process, so the
#: ServeSupervisor restarts (within its budget) and the request journal
#: replays queued/in-flight work.
EXIT_SERVE_ABORT = 45

#: Exit code of a worker whose JOB was declared dead rather than its
#: process: the job-level runtime (or a ``job_kill@jobN:abort`` chaos
#: fault standing in for it) decided a restart cannot help THIS job —
#: bad spec, poisoned data, exhausted budget. The job's own supervisor
#: lists it in ``no_restart_exits`` and the packing scheduler marks the
#: job ``failed`` (classification ``job_abort``) while its submesh slice
#: is released to the next queued job; neighbors never notice.
EXIT_JOB_ABORT = 47

#: Central protocol-exit registry: every NONZERO exit code the resilience
#: layer assigns a meaning to, with the classification name
#: ``Supervisor.classify_exit`` reports. 0 ("ok"), negative codes
#: ("signal_N") and everything unlisted ("crash") are handled by
#: :func:`classify_exit_code`; they are not protocol codes. Kept as one
#: literal tuple so a collision (two meanings, one code) is a single-file
#: diff — guarded by a tier-1 test.
_PROTOCOL_EXITS = (
    (EXIT_PEER_UNAVAILABLE, "peer_unavailable"),
    (EXIT_PREEMPTED, "preempted"),
    (EXIT_INTEGRITY, "integrity_abort"),
    (EXIT_FAULT_KILL, "fault_kill"),
    (EXIT_SERVE_ABORT, "serve_abort"),
    (EXIT_JOB_ABORT, "job_abort"),
)

#: code -> classification name, derived from :data:`_PROTOCOL_EXITS`.
EXIT_CODES = dict(_PROTOCOL_EXITS)


def classify_exit_code(code: int) -> str:
    """Classify a worker exit code against the protocol registry.

    ``0`` -> ``"clean"``; a registered protocol code -> its name; a negative
    code -> ``"signal_N"`` (killed by signal N, the subprocess convention);
    anything else -> ``"crash"``.
    """
    if code == 0:
        return "clean"
    name = EXIT_CODES.get(code)
    if name is not None:
        return name
    if code < 0:
        return f"signal_{-code}"
    return "crash"


#: "hang" is implemented as a bounded very-long delay: long enough that the
#: supervisor's per-attempt deadline is what ends it, short enough that an
#: unsupervised run eventually unwedges instead of leaking a process forever.
HANG_SECONDS = 3600.0

_TARGET_RE = re.compile(r"^(step|epoch|req|job)(\d+)$")

#: Environment variable carrying a packed job's submission index into its
#: worker gang (set by the JobPool's per-job supervisor); unset outside a
#: multi-job run. Lives here — not in tpu_dist.jobs — so the injector can
#: filter job-coordinate faults without importing the jobs subsystem.
JOB_INDEX_ENV = "TPU_DIST_JOB_INDEX"


def current_job_index() -> Optional[int]:
    """This process's packed-job submission index, or None outside a
    multi-job pool (or when the env var is malformed)."""
    raw = os.environ.get(JOB_INDEX_ENV)
    if raw is None or not raw.strip():
        return None
    try:
        return int(raw)
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault. Frozen: firing state (counts consumed) is
    tracked by the injector, so a spec can be shared and re-armed."""

    kind: str
    step: Optional[int] = None      # global step (epoch * steps_per_epoch + i)
    epoch: Optional[int] = None
    req: Optional[int] = None       # serve kinds: request coordinate
    job: Optional[int] = None       # job kinds: packed-job submission index
    rank: int = 0
    attempt: Optional[int] = 0      # None = every restart attempt
    seconds: float = 1.0            # delay/slow kinds
    count: int = 1                  # how many times it fires (ckpt/slow kinds)
    mode: str = "transient"         # checkpoint_fail: transient | truncate
    exit_code: int = EXIT_FAULT_KILL
    leaf: Optional[int] = None      # bitflip: param leaf index (flatten order)
    replica: Optional[int] = None   # bitflip: device position for the flip

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {list(KINDS)}")
        if self.kind in SERVE_KINDS:
            if self.req is None:
                raise ValueError(
                    f"serve fault {self.kind!r} needs a request coordinate "
                    f"(@reqN), got step={self.step} epoch={self.epoch}")
        elif self.req is not None:
            raise ValueError(
                f"fault {self.kind!r} is not a serve kind; @reqN targets "
                f"only {sorted(SERVE_KINDS)}")
        elif self.kind in JOB_KINDS:
            if self.job is None:
                raise ValueError(
                    f"job fault {self.kind!r} needs a job coordinate "
                    f"(@jobN), got step={self.step} epoch={self.epoch}")
            if self.step is None:
                # Fire at the job's first step boundary unless :stepN says
                # otherwise (frozen dataclass: object.__setattr__ is the
                # sanctioned __post_init__ escape hatch).
                object.__setattr__(self, "step", 1)
        elif self.step is None and self.epoch is None:
            raise ValueError(f"fault {self.kind!r} needs a step or epoch")
        if self.job is not None and self.kind not in JOB_KINDS:
            raise ValueError(
                f"fault {self.kind!r} is not a job kind; @jobN targets "
                f"only {sorted(JOB_KINDS)}")
        if self.leaf is not None and self.kind != "bitflip":
            raise ValueError(
                f"fault {self.kind!r} does not take :leafK; "
                f"that addresses only bitflip")
        if (self.replica is not None
                and self.kind not in ("bitflip", "replica_kill")):
            raise ValueError(
                f"fault {self.kind!r} does not take :replicaR; "
                f"that addresses only bitflip and replica_kill")
        if self.kind == "checkpoint_fail" and self.mode not in (
                "transient", "truncate"):
            raise ValueError(
                f"checkpoint_fail mode must be transient|truncate, "
                f"got {self.mode!r}")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1, got {self.count}")

    # -- firing predicate (pure; injector owns mutable fired-state) ----------

    def matches_process(self, rank: int, attempt: int) -> bool:
        return rank == self.rank and (
            self.attempt is None or attempt == self.attempt)

    def matches_job(self, job_index: Optional[int]) -> bool:
        """Job-domain filter: a fault without a job coordinate applies
        everywhere; one WITH a coordinate applies only inside the worker
        gang whose ``$TPU_DIST_JOB_INDEX`` matches. A job-coordinate fault
        reaching a process outside any pool (``job_index is None``) does
        NOT arm — a stray plan must never fire in a solo run."""
        return self.job is None or (job_index is not None
                                    and job_index == self.job)

    def due_at_step(self, global_step: int) -> bool:
        """Step-triggered kinds: due once the global step reaches the
        target (``>=`` so steps_per_execution > 1 cannot jump past it)."""
        return self.step is not None and global_step >= self.step

    def due_at_epoch(self, epoch: int) -> bool:
        return self.epoch is not None and epoch >= self.epoch

    def due_at_req(self, n: int) -> bool:
        """Serve kinds: due once the request coordinate (completed count
        for engine_crash/decode_stall, submission index for request_storm)
        reaches the target (``>=`` — same no-jump-past semantics as steps)."""
        return self.req is not None and n >= self.req

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}

    @classmethod
    def from_json(cls, obj: dict) -> "FaultSpec":
        kind = _ALIASES.get(str(obj.get("kind", "")), obj.get("kind"))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown FaultSpec field(s) {sorted(unknown)}")
        kwargs = dict(obj)
        kwargs["kind"] = kind
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    faults: tuple = ()

    def __bool__(self) -> bool:
        return bool(self.faults)

    def for_process(self, rank: int, attempt: int) -> "list[FaultSpec]":
        return [f for f in self.faults if f.matches_process(rank, attempt)]

    def to_json(self) -> dict:
        return {"faults": [f.to_json() for f in self.faults]}

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_json(cls, obj: dict) -> "FaultPlan":
        if not isinstance(obj, dict) or "faults" not in obj:
            raise ValueError(
                'a JSON fault plan must be {"faults": [...]}')
        return cls(tuple(FaultSpec.from_json(f) for f in obj["faults"]))

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a plan from JSON, ``@path/to/plan.json``, or the compact
        comma-separated spec grammar (module docstring)."""
        text = text.strip()
        if not text:
            return cls()
        if text.startswith("@"):
            with open(text[1:], "r", encoding="utf-8") as fh:
                return cls.from_json(json.load(fh))
        if text.startswith("{"):
            return cls.from_json(json.loads(text))
        return cls(tuple(_parse_compact(s) for s in text.split(",")
                         if s.strip()))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """The plan named by ``$TPU_DIST_FAULT_PLAN``, or None. A plan that
        does not parse is a hard error — a silently-ignored chaos plan would
        report a vacuous pass."""
        raw = os.environ.get(FAULT_PLAN_ENV)
        if not raw or not raw.strip():
            return None
        return cls.parse(raw)


def _parse_compact(spec: str) -> FaultSpec:
    """``kind@target[:modifier]*`` -> FaultSpec (see module docstring)."""
    spec = spec.strip()
    if "@" not in spec:
        raise ValueError(
            f"bad fault spec {spec!r}: expected kind@stepN, kind@epochN or "
            f"kind@reqN")
    head, _, tail = spec.partition("@")
    kind = _ALIASES.get(head.strip(), head.strip())
    if kind not in KINDS:
        raise ValueError(
            f"unknown fault kind {head.strip()!r} in {spec!r}; "
            f"valid: {sorted(set(KINDS) | set(_ALIASES))}")
    parts = [p.strip() for p in tail.split(":") if p.strip()]
    if not parts:
        raise ValueError(f"bad fault spec {spec!r}: missing @step/@epoch/@req")
    m = _TARGET_RE.match(parts[0])
    if not m and parts[0] == "step*":
        # Wildcard step target: due from step 0 with an effectively
        # unbounded firing count — "this fault is a standing condition",
        # e.g. a permanent straggler (`delay@step*:rankN:always`).
        kwargs: dict = {"step": 0, "count": WILDCARD_COUNT}
    elif not m:
        raise ValueError(
            f"bad fault target {parts[0]!r} in {spec!r}: "
            "expected stepN, step*, epochN or reqN")
    else:
        kwargs = {m.group(1): int(m.group(2))}
    for mod in parts[1:]:
        if mod.startswith("rank") and mod[4:].isdigit():
            kwargs["rank"] = int(mod[4:])
        elif mod.startswith("attempt") and mod[7:].isdigit():
            kwargs["attempt"] = int(mod[7:])
        elif mod.startswith("step") and mod[4:].isdigit():
            # Job kinds: the in-job step the fault fires at (the @target
            # slot is taken by the job coordinate).
            kwargs["step"] = int(mod[4:])
        elif mod.startswith("replica") and mod[7:].isdigit():
            kwargs["replica"] = int(mod[7:])
        elif mod.startswith("leaf") and mod[4:].isdigit():
            kwargs["leaf"] = int(mod[4:])
        elif mod == "abort":
            kwargs["exit_code"] = EXIT_JOB_ABORT
        elif mod == "always":
            kwargs["attempt"] = None
        elif mod.startswith("x") and mod[1:].isdigit():
            kwargs["count"] = int(mod[1:])
        elif mod.endswith("s") and _is_number(mod[:-1]):
            kwargs["seconds"] = float(mod[:-1])
        elif mod in ("transient", "truncate"):
            kwargs["mode"] = mod
        else:
            raise ValueError(f"unknown fault modifier {mod!r} in {spec!r}")
    return FaultSpec(kind=kind, **kwargs)


def _is_number(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return True


def describe(plan: FaultPlan) -> Sequence[str]:
    """Human-readable one-liners, one per fault (CLI/report rendering)."""
    out = []
    for f in plan.faults:
        where = (f"job {f.job} step {f.step}" if f.job is not None
                 else f"req {f.req}" if f.req is not None
                 else "every step" if (f.step == 0
                                       and f.count >= WILDCARD_COUNT)
                 else f"step {f.step}" if f.step is not None
                 else f"epoch {f.epoch}")
        when = ("every attempt" if f.attempt is None
                else f"attempt {f.attempt}")
        addr = ""
        if f.kind == "replica_kill":
            addr = f" [replica {0 if f.replica is None else f.replica}]"
        elif f.leaf is not None or f.replica is not None:
            addr = (f" [leaf {0 if f.leaf is None else f.leaf}"
                    f", replica {f.rank if f.replica is None else f.replica}]")
        out.append(f"{f.kind} @ {where} on rank {f.rank} ({when}){addr}")
    return out
