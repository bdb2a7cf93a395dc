"""ServeFleet: N supervised ServeEngine replicas behind one host router.

Counterpart of ``tpu_dist/serve/fleet.py``. The single-engine serving
stack (``serve/engine.py``) serves one stream of traffic; this module
scales the same program sideways by running N replica workers, each a
daemon thread that owns one :class:`ServeEngine`, fronted by a
main-thread router. On one card the replicas share the card and the
interpreter: each replica's captured graphs live in its own memory pool,
their captures are serialised (``utils/graphs.py``), and their launches
interleave on the card.

* **Prefix-affinity routing** — the router keys every request by the
  chained digest of its *full-page* prompt prefix, computed with
  :meth:`PrefixCache.prompt_digest` (the exact key under which the
  paged KV prefix cache holds those pages warm), and routes same-prefix
  sessions to the replica whose pages are warm.  Unknown prefixes — and
  prompts shorter than one page, which have no reusable pages — fall
  back to the least-loaded replica (lowest outstanding count, lowest
  index on ties), and known prefixes stick there.
* **Journal-backed failover** — each replica journals to its own
  directory.  When a replica dies, the router joins its thread, loads
  the journal from disk (torn trailing lines are skipped by
  ``journal.load``, same as solo recovery), and re-adopts every still
  in-flight request onto a survivor via
  :meth:`ServeEngine.adopt_request` — which reserves a **fresh rid**
  through ``Scheduler.reserve_rid`` so two dead replicas' overlapping
  rid spaces can merge onto one survivor without collisions.  Tokens
  that reached the dead replica's journal are replayed (greedy
  re-prefill continues the stream token-identically); tokens lost in
  the unflushed tail are simply regenerated — greedy decode is
  batch-composition-independent, so the final stream is bit-identical
  either way on the CPU; on the card a different batch can round an
  fp32 near-tie the other way, which :func:`run_fleet` accepts only where
  the full forward certifies the tie (``serve/chaos.py``'s rule).
  Survivors are never restarted: blast radius zero.
* **Autoscaling** — :meth:`ServeFleet.autoscale_tick` applies a
  deterministic :class:`AutoscalePolicy` over router-side queue depth
  and the projected-TTFT signal (``owed / (replicas * max_batch) *
  step_ema``), spawning replicas up to ``max_replicas`` and retiring
  idle ones down to ``min_replicas``.

Fault grammar (``resilience/faults.py``): ``replica_kill@reqN:replicaR``
kills replica R in-process at its N-th completion — *before* the journal
flush, so the unflushed tail is genuinely lost, like a process death —
and ``router_storm@reqN:xM`` injects an M-request chaff burst through
the router at submission index N.  Both are armed only here; the solo
chaos driver rejects them.

``devices_per_replica`` leases each replica a slot of a
:class:`~tpu_dist_torch.jobs.runtime.MeshRuntime` (one slot a replica on
the fleet's ``device``: replicas of one process share its card) and runs
it under :func:`~tpu_dist_torch.jobs.runtime.job_scope`, so its engine's
captured programs live in the runtime's cache; a replica of several
devices is ROADMAP item 12b and raises ``unported``.

Threading contract: each engine is constructed
AND stepped only on its worker thread (thread-confined); the router
talks to workers through a command inbox and a shared event queue, and
reads the small shared worker state (rid map, stats) under the worker's
lock.  All router state (affinity map, outstanding counters, in-flight
tables) is main-thread-only.  After ``join()`` a worker's engine is
quiescent and safe to read directly (e.g. ``compiled_programs()``).

Observe: ``fleet.replicas`` gauge, ``fleet.route.affinity_hits`` /
``fleet.route.affinity_overridden`` / ``fleet.route.fallback`` /
``fleet.failover.replayed`` counters, ``fleet.autoscale.up`` /
``fleet.autoscale.down``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import pathlib
import queue
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from tpu_dist_torch.observe import metrics
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (FLEET_KINDS, FaultPlan,
                                              FaultSpec,
                                              describe as describe_faults)
from tpu_dist_torch.serve import journal as journal_lib
from tpu_dist_torch.serve.paging import PrefixCache
from tpu_dist_torch.serve.scheduler import ACTIVE, DONE, QUEUED
from tpu_dist_torch.utils.errors import unported

logger = logging.getLogger("tpu_dist_torch.serve.fleet")

__all__ = [
    "AutoscalePolicy",
    "FleetRequest",
    "ReplicaKilled",
    "ReplicaWorker",
    "ServeFleet",
    "run_fleet",
]


class ReplicaKilled(RuntimeError):
    """Raised inside a replica worker by an armed ``replica_kill`` fault.

    Raised from the engine's ``fault_injector.on_step_end`` hook, which
    runs *before* ``journal.flush()`` — so the step's journal records
    are lost with the replica, exactly like a process kill between a
    decode step and its fsync.
    """


class FleetFaultInjector:
    """Per-replica injector for fleet fault kinds (duck-typed on the
    engine's ``on_decode`` / ``on_step_end`` hook protocol).

    Only ``replica_kill`` specs addressed at this replica index are
    armed; everything else in the plan is the router's business.  The
    solo :class:`ServeFaultInjector` never arms fleet kinds
    (``ENGINE_KINDS`` is unchanged), so the two grammars cannot cross.
    """

    def __init__(self, replica: int, faults: Sequence[FaultSpec] = ()):
        self.replica = replica
        self.faults = [
            f for f in faults
            if f.kind == "replica_kill"
            and (0 if f.replica is None else f.replica) == replica
        ]
        self.fired: List[dict] = []
        for f in self.faults:
            events.maybe_log("fault_armed", kind=f.kind, req=f.req,
                             replica=replica)

    def on_decode(self) -> None:
        """No decode-time faults in the fleet grammar."""

    def on_step_end(self, done_count: int) -> None:
        for f in self.faults:
            if (f.due_at_req(done_count)
                    and not any(r["req"] == f.req for r in self.fired)):
                rec = {"kind": "replica_kill", "req": f.req,
                       "replica": self.replica, "done": done_count}
                self.fired.append(rec)
                events.maybe_log("fault_fired", **rec)
                raise ReplicaKilled(
                    f"replica {self.replica} killed at done_count="
                    f"{done_count} (replica_kill@req{f.req})")


@dataclasses.dataclass
class FleetRequest:
    """Router-side view of one request across its whole fleet lifetime
    (the engine-side :class:`Request` is per-replica and dies with it)."""

    frid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    deadline_s: Optional[float]
    #: full-page prefix-chain digest (the affinity key), or None when
    #: the prompt is shorter than one page (no reusable pages).
    digest: Optional[bytes]
    replica: int = -1
    route: Optional[str] = None      # affinity | overridden | fallback
    chaff: bool = False              # router_storm filler
    failovers: int = 0
    status: Optional[str] = None     # terminal engine status, or "rejected"
    finish_reason: Optional[str] = None
    shed_cause: Optional[str] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    rid: Optional[int] = None        # rid on the replica that finished it
    latency_s: Optional[float] = None


class ReplicaWorker:
    """One supervised replica: a daemon thread that owns one ServeEngine.

    The engine is built by ``factory(index, journal=..., fault_injector=
    ...)`` *on the worker thread* and never touched by another thread
    while the worker is alive.  Communication is one-way queues: the
    router posts ``("submit", fr)`` / ``("adopt", fr, generated,
    replays)`` commands into the inbox; the worker publishes ``("done",
    index, frid, req)``, ``("rejected", index, frid, why)``, ``("dead",
    index, why, killed)`` and ``("retired", index)`` events onto the
    fleet-shared event queue.  The rid→frid map and a small stats
    snapshot are shared under ``self._lock``.

    A ``replica_kill`` fault (or any unexpected exception) abandons the
    engine without flushing or closing its journal — the on-disk journal
    is missing the unflushed tail on purpose, so failover recovery has
    to work from durable state alone, like after a real process death.
    """

    def __init__(self, index: int, factory: Callable, *,
                 events_q: "queue.Queue", poll_s: float = 0.005,
                 faults: Sequence[FaultSpec] = (),
                 journal_dir: Optional[str] = None,
                 runtime=None, spec=None):
        self.index = index
        self._runtime = runtime          # MeshRuntime, or None (no lease)
        self._spec = spec                # JobSpec for the lease, or None
        self._factory = factory
        self._events = events_q
        self._poll_s = float(poll_s)
        self.journal_dir = journal_dir
        self.injector = FleetFaultInjector(index, faults)
        self._inbox: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-replica-{index}", daemon=True)
        # Shared worker state (written on the worker thread under _lock;
        # read by the router under _lock, or freely after join()).
        self.engine = None
        self.dead = False
        self.killed = False
        self.death: Optional[str] = None
        #: supervised-restart count — the chaos gate pins this at 0 for
        #: survivors (failover must not restart healthy replicas).
        self.restarts = 0
        self.stats: dict = {}
        self._rid_map: Dict[int, int] = {}   # engine rid -> frid
        self._published = 0                  # index into engine.finished

    # -- router-side API ------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def post(self, cmd: tuple) -> None:
        self._inbox.put(cmd)

    def stop(self) -> None:
        """Ask for graceful retirement: drain accepted work, then exit."""
        self._stop.set()

    def join(self, timeout_s: float = 10.0) -> bool:
        self._thread.join(timeout_s)
        return not self._thread.is_alive()

    def alive(self) -> bool:
        with self._lock:
            return not self.dead

    def rid_map(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._rid_map)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)

    # -- worker thread --------------------------------------------------------

    def _run(self) -> None:
        try:
            if self._runtime is not None and self._spec is not None:
                from tpu_dist_torch.jobs.runtime import job_scope

                with job_scope(self._runtime, self._spec):
                    self._serve()
            else:
                self._serve()
        except ReplicaKilled as exc:
            self._die(str(exc), killed=True)
        except BaseException as exc:  # replica death is data, not a crash
            logger.exception("fleet: replica %d died", self.index)
            self._die(f"{type(exc).__name__}: {exc}", killed=False)

    def _serve(self) -> None:
        engine = self._factory(self.index, journal=self.journal_dir,
                               fault_injector=self.injector)
        with self._lock:
            self.engine = engine
        while not self._stop.is_set():
            moved = self._drain_inbox(engine)
            if engine.scheduler.idle():
                if not moved:
                    try:
                        # Park until the next command; bounded so the
                        # stop flag is re-checked every poll interval.
                        cmd = self._inbox.get(True, self._poll_s)
                    except queue.Empty:
                        continue
                    self._apply(engine, cmd)
                self._publish(engine)
                continue
            engine.step()
            self._publish(engine)
        # Graceful retirement: finish everything already accepted.
        while not engine.scheduler.idle():
            engine.step()
            self._publish(engine)
        engine.close()
        self._publish(engine)
        with self._lock:
            self.dead = True
            self.death = "retired"
        self._events.put(("retired", self.index))

    def _die(self, why: str, *, killed: bool) -> None:
        # The engine is abandoned un-flushed and un-closed on purpose:
        # an injected kill must look like a process death, so the
        # on-disk journal is missing the unflushed tail and failover
        # has to recover from durable state alone.
        with self._lock:
            self.dead = True
            self.killed = killed
            self.death = why
        self._events.put(("dead", self.index, why, killed))

    def _drain_inbox(self, engine) -> bool:
        moved = False
        while True:
            try:
                cmd = self._inbox.get_nowait()
            except queue.Empty:
                return moved
            self._apply(engine, cmd)
            moved = True

    def _apply(self, engine, cmd: tuple) -> None:
        op = cmd[0]
        if op == "submit":
            fr = cmd[1]
            try:
                req = engine.submit(fr.prompt,
                                    max_new_tokens=fr.max_new_tokens,
                                    eos_id=fr.eos_id,
                                    deadline_s=fr.deadline_s)
            except ValueError as exc:
                self._events.put(("rejected", self.index, fr.frid, str(exc)))
                return
        elif op == "adopt":
            fr, generated, replays = cmd[1], cmd[2], cmd[3]
            try:
                req = engine.adopt_request(fr.prompt, generated=generated,
                                           max_new_tokens=fr.max_new_tokens,
                                           eos_id=fr.eos_id,
                                           deadline_s=fr.deadline_s,
                                           replays=replays)
            except ValueError as exc:
                self._events.put(("rejected", self.index, fr.frid, str(exc)))
                return
        else:
            raise RuntimeError(f"fleet: unknown worker command {op!r}")
        with self._lock:
            self._rid_map[req.rid] = fr.frid
        # Shed-on-submit and adopt-to-done are terminal immediately
        # (already in engine.finished) — surface them without waiting
        # for the next step.
        if req.status not in (QUEUED, ACTIVE):
            self._publish(engine)

    def _publish(self, engine) -> None:
        new = engine.finished[self._published:]
        self._published = len(engine.finished)
        with self._lock:
            self.stats = {
                "done": len(engine.finished),
                "step_ema_s": engine._step_ema_s,
                "queue_depth": engine.scheduler.queue_depth(),
                "active": engine.scheduler.num_active,
                "max_batch": engine.max_batch,
            }
            frids = [self._rid_map.get(req.rid) for req in new]
        for req, frid in zip(new, frids):
            self._events.put(("done", self.index, frid, req))


@dataclasses.dataclass
class AutoscalePolicy:
    """Deterministic scale decisions from router-side signals.

    Scale **up** when every live replica's outstanding count reaches
    ``scale_up_outstanding`` (backlog nowhere to shed to), or when the
    projected TTFT — ``sum(outstanding) / (replicas * max_batch) *
    step_ema`` , the fleet-level analog of the engine's admission
    signal — exceeds ``ttft_target_s``.  Scale **down** when a replica
    has been idle (zero outstanding) for ``idle_ticks_down``
    consecutive ticks AND no other replica holds more than
    ``scale_down_max_load`` — retiring idle capacity while the rest of
    the fleet is backlogged would just re-trigger scale-up (thrash).
    Bounded by ``min_replicas``/``max_replicas``.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_outstanding: int = 8
    ttft_target_s: Optional[float] = None
    idle_ticks_down: int = 50
    scale_down_max_load: int = 0

    def decide(self, *, outstanding: Dict[int, int],
               idle_ticks: Dict[int, int],
               step_ema_s: Optional[float],
               max_batch: int) -> tuple:
        """Return ``(action, target, why)`` with action in
        ``{"up", "down", "hold"}``; target is the replica index to
        retire for ``"down"``, else ``None``."""
        n = len(outstanding)
        if n < self.max_replicas and n > 0:
            if min(outstanding.values()) >= self.scale_up_outstanding:
                return ("up", None,
                        f"backlog >= {self.scale_up_outstanding} on every "
                        f"replica")
            if self.ttft_target_s is not None and step_ema_s:
                owed = sum(outstanding.values())
                projected = (owed / max(n * max_batch, 1)) * step_ema_s
                if projected > self.ttft_target_s:
                    return ("up", None,
                            f"projected TTFT {projected:.4f}s > "
                            f"{self.ttft_target_s}s")
        if n > self.min_replicas:
            idle = [i for i in sorted(outstanding)
                    if idle_ticks.get(i, 0) >= self.idle_ticks_down]
            if idle:
                # Retire the highest index: lowest indices hold the
                # oldest prefix affinities.
                cand = idle[-1]
                others = [v for i, v in outstanding.items() if i != cand]
                if not others or max(others) <= self.scale_down_max_load:
                    return ("down", cand,
                            f"idle for {self.idle_ticks_down} ticks")
        return ("hold", None, "")


class ServeFleet:
    """Main-thread router over :class:`ReplicaWorker` replicas.

    All router state lives on the calling thread; the only cross-thread
    traffic is the per-worker command inbox and the shared event queue.
    Typical use::

        fleet = ServeFleet(factory, replicas=2)
        fleet.start()
        frs = [fleet.submit(p) for p in prompts]
        fleet.drain()
        fleet.close()
        programs = fleet.compiled_programs()   # safe: threads joined

    ``factory(replica_index, *, journal, fault_injector)`` must build a
    fresh ServeEngine; it runs on the worker thread.
    ``devices_per_replica=1`` leases each replica a slot of ``runtime``
    (default: one slot a possible replica, each ``device``, the CUDA
    device unless ``"cpu"``) under a job scope; more than 1 is ROADMAP
    item 12b.
    """

    def __init__(self, factory: Callable, *, replicas: int = 2,
                 page_size: int = 16,
                 journal_root: Optional[str] = None,
                 plan: Optional[FaultPlan] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 devices_per_replica: Optional[int] = None,
                 runtime=None, storm_vocab: int = 128,
                 storm_seed: int = 0, poll_s: float = 0.005,
                 affinity_load_slack: Optional[int] = 8,
                 device=None):
        if devices_per_replica is not None and int(devices_per_replica) > 1:
            raise unported("a fleet replica of several devices in one "
                           "process", "12b")
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        self._factory = factory
        self._devices_per_replica = devices_per_replica
        self._runtime = runtime
        self._device = device
        self._page_size = int(page_size)
        self._poll_s = float(poll_s)
        self._autoscale = autoscale
        self._storm_vocab = int(storm_vocab)
        self._storm_seed = int(storm_seed)
        if journal_root is None:
            journal_root = tempfile.mkdtemp(prefix="tpu-dist-fleet-")
        self._journal_root = pathlib.Path(journal_root)
        plan = plan or FaultPlan()
        self._kill_faults = [f for f in plan.faults
                             if f.kind == "replica_kill"]
        self._storm_faults = [f for f in plan.faults
                              if f.kind == "router_storm"]
        foreign = [f for f in plan.faults if f.kind not in FLEET_KINDS]
        if foreign:
            raise ValueError(
                f"fleet plan contains non-fleet fault kinds "
                f"{sorted({f.kind for f in foreign})}; run those through "
                f"--chaos against a solo engine")
        self._storm_fired: List[dict] = []
        self._workers: Dict[int, ReplicaWorker] = {}
        self._retiring: set = set()
        self._events: "queue.Queue" = queue.Queue()
        self._affinity: Dict[bytes, int] = {}
        self._outstanding: Dict[int, int] = {}
        self._inflight: Dict[int, Dict[int, FleetRequest]] = {}
        self._idle_ticks: Dict[int, int] = {}
        self._frid = itertools.count()
        self._submit_index = 0
        self._initial = int(replicas)
        self._next_index = int(replicas)
        self.requests: Dict[int, FleetRequest] = {}
        # Hot-prefix load shed: affinity stops being a hard pin once the
        # pinned replica is this many outstanding requests ahead of the
        # least-loaded one (None disables the override entirely).
        self._affinity_load_slack = (None if affinity_load_slack is None
                                     else max(0, int(affinity_load_slack)))
        self.route_counts = {"affinity": 0, "fallback": 0,
                             "affinity_overridden": 0}
        self.failover_replayed = 0
        self.deaths: List[dict] = []
        self.autoscale_events: List[dict] = []

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        for i in range(self._initial):
            self._spawn(i)

    def _spawn(self, index: int) -> ReplicaWorker:
        jdir = self._journal_root / f"replica-{index}"
        jdir.mkdir(parents=True, exist_ok=True)
        runtime = spec = None
        if self._devices_per_replica:
            from tpu_dist_torch.jobs.spec import JobSpec

            runtime = self._ensure_runtime()
            spec = JobSpec(name=f"fleet-r{index}", kind="serve",
                           devices=int(self._devices_per_replica))
        w = ReplicaWorker(index, self._factory, events_q=self._events,
                          poll_s=self._poll_s, faults=self._kill_faults,
                          journal_dir=str(jdir), runtime=runtime, spec=spec)
        self._workers[index] = w
        self._outstanding[index] = 0
        self._inflight[index] = {}
        self._idle_ticks[index] = 0
        w.start()
        metrics.set_gauge("fleet.replicas", float(len(self.alive_indices())))
        return w

    def _ensure_runtime(self):
        """The replicas' pool: one slot a replica the fleet may hold (its
        initial count, or the autoscaler's bound), each the fleet's
        device."""
        if self._runtime is None:
            from tpu_dist_torch.jobs.runtime import MeshRuntime
            from tpu_dist_torch.utils.device import resolve_device

            most = max(self._initial, self._autoscale.max_replicas
                       if self._autoscale is not None else 0)
            device = resolve_device(self._device)
            self._runtime = MeshRuntime(
                [device] * (most * int(self._devices_per_replica)))
        return self._runtime

    def close(self, *, timeout_s: float = 30.0) -> None:
        """Gracefully retire every replica: drain accepted work, flush
        journals, join threads.  After this the fleet is quiescent."""
        for w in self._workers.values():
            w.stop()
        stuck = [w.index for w in self._workers.values()
                 if not w.join(timeout_s)]
        if stuck:
            raise TimeoutError(
                f"fleet: replica thread(s) {stuck} did not exit within "
                f"{timeout_s}s")
        metrics.set_gauge("fleet.replicas", 0.0)

    def alive_indices(self) -> List[int]:
        return sorted(i for i, w in self._workers.items()
                      if i not in self._retiring and w.alive())

    # -- routing --------------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               chaff: bool = False) -> FleetRequest:
        """Route one request: prefix-affinity first, least-loaded
        fallback.  Returns the router-side :class:`FleetRequest`;
        terminal state lands on it during :meth:`drain`."""
        if not chaff:
            self._maybe_storm()
        # Affinity keys on the *full-page* prefix chain — exactly the
        # pages the prefix cache can hold warm across requests. The
        # ragged tail never lands in a reusable full page, so it does
        # not contribute to warmth; prompts shorter than one page have
        # no reusable pages at all and route stateless (least-loaded).
        k_full = len(prompt) // self._page_size
        digest = (PrefixCache.prompt_digest(
            list(prompt)[:k_full * self._page_size], self._page_size)
            if k_full else None)
        fr = FleetRequest(frid=next(self._frid),
                          prompt=[int(t) for t in prompt],
                          max_new_tokens=int(max_new_tokens),
                          eos_id=eos_id, deadline_s=deadline_s,
                          digest=digest, chaff=chaff)
        self.requests[fr.frid] = fr
        self._submit_index += 1
        self._route(fr)
        return fr

    def _route(self, fr: FleetRequest) -> None:
        alive = self.alive_indices()
        if not alive:
            self._reap(block=True)
            alive = self.alive_indices()
            if not alive:
                raise RuntimeError("fleet: no live replicas to route to")
        target = (self._affinity.get(fr.digest)
                  if fr.digest is not None else None)
        if target is not None and target in alive:
            coldest = min(alive, key=lambda i: (self._outstanding[i], i))
            if (self._affinity_load_slack is not None
                    and self._outstanding[target]
                    - self._outstanding[coldest]
                    > self._affinity_load_slack):
                # Hot-prefix load shed: warmth is not worth queueing this
                # far behind the coldest replica. Route there for THIS
                # request only — the affinity pin stays on the hot
                # replica, so routing snaps back once its queue drains
                # instead of migrating the prefix on a transient spike.
                target = coldest
                fr.route = "overridden"
                self.route_counts["affinity_overridden"] += 1
                metrics.inc("fleet.route.affinity_overridden")
            else:
                fr.route = "affinity"
                self.route_counts["affinity"] += 1
                metrics.inc("fleet.route.affinity_hits")
        else:
            target = min(alive, key=lambda i: (self._outstanding[i], i))
            fr.route = "fallback"
            self.route_counts["fallback"] += 1
            metrics.inc("fleet.route.fallback")
            if fr.digest is not None:
                self._affinity[fr.digest] = target
        fr.replica = target
        self._outstanding[target] += 1
        self._inflight[target][fr.frid] = fr
        self._workers[target].post(("submit", fr))

    def _maybe_storm(self) -> None:
        for f in self._storm_faults:
            if (f.due_at_req(self._submit_index)
                    and not any(r["req"] == f.req
                                for r in self._storm_fired)):
                rec = {"kind": "router_storm", "req": f.req,
                       "count": f.count, "at_index": self._submit_index}
                self._storm_fired.append(rec)
                events.maybe_log("fault_fired", **rec)
                metrics.inc("fleet.router_storm.injected", f.count)
                # Seeded chaff: short prompts, tiny budgets — load, not
                # output. Deterministic per (seed, storm index).
                import numpy as np
                rng = np.random.default_rng(
                    self._storm_seed + 7919 * f.req)
                for _ in range(f.count):
                    plen = int(rng.integers(1, self._page_size + 1))
                    self.submit(
                        rng.integers(0, self._storm_vocab,
                                     size=plen).tolist(),
                        max_new_tokens=int(rng.integers(1, 5)),
                        chaff=True)

    # -- event pump / failover ------------------------------------------------

    def pending(self) -> int:
        return sum(len(m) for m in self._inflight.values())

    def drain(self, *, timeout_s: float = 120.0) -> None:
        """Pump events until every routed request is terminal.  Runs
        autoscale ticks opportunistically when a policy is configured."""
        deadline = time.monotonic() + timeout_s
        while self.pending() > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet: {self.pending()} request(s) still in flight "
                    f"after {timeout_s}s; deaths={self.deaths}")
            self._pump(0.05)
            if self._autoscale is not None:
                self.autoscale_tick()

    def _pump(self, timeout_s: float) -> bool:
        try:
            ev = self._events.get(True, timeout_s)
        except queue.Empty:
            return False
        self._handle(ev)
        while True:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                return True
            self._handle(ev)

    def _reap(self, *, block: bool = False) -> None:
        """Drain pending events (used before routing when no replica
        looks alive — a death event may simply not be handled yet)."""
        self._pump(1.0 if block else 0.0)

    def _handle(self, ev: tuple) -> None:
        kind = ev[0]
        if kind == "done":
            _, idx, frid, req = ev
            fr = self._inflight.get(idx, {}).pop(frid, None)
            if fr is None:
                return  # finished during failover handoff; already settled
            self._outstanding[idx] = max(self._outstanding[idx] - 1, 0)
            fr.status = req.status
            fr.finish_reason = req.finish_reason
            fr.shed_cause = req.shed_cause
            fr.tokens = list(req.generated)
            fr.rid = req.rid
            fr.latency_s = req.latency_s
        elif kind == "rejected":
            _, idx, frid, why = ev
            fr = self._inflight.get(idx, {}).pop(frid, None)
            if fr is not None:
                self._outstanding[idx] = max(self._outstanding[idx] - 1, 0)
                fr.status = "rejected"
                fr.finish_reason = why
        elif kind == "dead":
            _, idx, why, killed = ev
            self._failover(idx, why=why, killed=killed)
        elif kind == "retired":
            _, idx = ev
            self._retiring.discard(idx)
            metrics.set_gauge("fleet.replicas",
                              float(len(self.alive_indices())))

    def _failover(self, idx: int, *, why: str, killed: bool) -> None:
        """Replay a dead replica's in-flight requests onto survivors.

        The worker thread is joined first, so its journal file is stable
        and its rid map is safe to read.  Requests whose submit never
        reached the journal (lost in the unflushed tail, or still queued
        in the inbox) replay from the router's own copy with zero
        generated tokens — greedy decode regenerates the identical
        stream.  Requests with journaled tokens resume mid-stream via
        ``adopt_request``, which reserves a fresh rid on the survivor
        (the collision guard when two dead replicas' rid spaces merge).
        """
        w = self._workers[idx]
        w.join(10.0)
        self.deaths.append({"replica": idx, "why": why, "killed": killed,
                            "fired": list(w.injector.fired)})
        metrics.set_gauge("fleet.replicas", float(len(self.alive_indices())))
        logger.warning("fleet: replica %d dead (%s); failing over %d "
                       "request(s)", idx, why, len(self._inflight[idx]))
        orphans = sorted(self._inflight[idx].values(), key=lambda f: f.frid)
        self._inflight[idx] = {}
        self._outstanding[idx] = 0
        # Torn trailing lines (a kill can land mid-append) are skipped
        # by journal.load — same tolerance as solo recovery.
        state = journal_lib.load(
            pathlib.Path(w.journal_dir) / journal_lib.JOURNAL_NAME)
        by_frid: Dict[int, journal_lib.JournaledRequest] = {}
        for rid, frid in w.rid_map().items():
            jr = state.requests.get(rid)
            if jr is not None:
                by_frid[frid] = jr
        for fr in orphans:
            jr = by_frid.get(fr.frid)
            generated = list(jr.tokens) if jr is not None else []
            self._adopt(fr, generated=generated)

    def _adopt(self, fr: FleetRequest, *, generated: List[int]) -> None:
        survivors = self.alive_indices()
        if not survivors:
            raise RuntimeError(
                f"fleet: request frid={fr.frid} orphaned with no "
                f"surviving replicas")
        target = min(survivors, key=lambda i: (self._outstanding[i], i))
        fr.failovers += 1
        fr.replica = target
        # The session's warm pages died with the replica; future
        # same-prefix requests should follow the adopted work.
        if fr.digest is not None:
            self._affinity[fr.digest] = target
        self._outstanding[target] += 1
        self._inflight[target][fr.frid] = fr
        self.failover_replayed += 1
        metrics.inc("fleet.failover.replayed")
        self._workers[target].post(
            ("adopt", fr, list(generated), fr.failovers - 1))

    # -- autoscaling ----------------------------------------------------------

    def autoscale_tick(self) -> Optional[str]:
        """Apply one deterministic autoscale decision; returns the
        action taken (``"up"``/``"down"``) or None."""
        if self._autoscale is None:
            return None
        alive = self.alive_indices()
        if not alive:
            return None
        for i in alive:
            if self._outstanding[i] == 0:
                self._idle_ticks[i] += 1
            else:
                self._idle_ticks[i] = 0
        outstanding = {i: self._outstanding[i] for i in alive}
        emas = [s.get("step_ema_s") for s in
                (self._workers[i].snapshot() for i in alive)]
        emas = [e for e in emas if e]
        batches = [self._workers[i].snapshot().get("max_batch") or 0
                   for i in alive]
        action, target, why = self._autoscale.decide(
            outstanding=outstanding,
            idle_ticks={i: self._idle_ticks[i] for i in alive},
            step_ema_s=(sum(emas) / len(emas)) if emas else None,
            max_batch=max(batches) if any(batches) else 1)
        if action == "up":
            index = self._next_index
            self._next_index += 1
            self._spawn(index)
            metrics.inc("fleet.autoscale.up")
            self.autoscale_events.append(
                {"action": "up", "replica": index, "why": why})
            logger.info("fleet: autoscale up -> replica %d (%s)", index, why)
            return "up"
        if action == "down":
            # Only retire a truly idle replica; routing excludes it from
            # this tick on, so no command can land after stop().
            if self._outstanding.get(target, 0) == 0:
                self._retiring.add(target)
                self._workers[target].stop()
                metrics.inc("fleet.autoscale.down")
                self.autoscale_events.append(
                    {"action": "down", "replica": target, "why": why})
                logger.info("fleet: autoscale down -> retire replica %d "
                            "(%s)", target, why)
                return "down"
        return None

    # -- post-quiescence inspection ------------------------------------------

    def compiled_programs(self) -> Dict[int, dict]:
        """Per-replica ``ServeEngine.compiled_programs()``.  Call only
        after :meth:`close` (or after a replica died and was joined) —
        engines are thread-confined while their worker runs."""
        out: Dict[int, dict] = {}
        for i, w in sorted(self._workers.items()):
            if w.alive():
                raise RuntimeError(
                    f"fleet: replica {i} still running; close() first")
            if w.engine is not None:
                out[i] = w.engine.compiled_programs()
        return out

    def graph_stats(self) -> Dict[int, dict]:
        """Per-replica CUDA-graph use: programs captured, replays, capture
        seconds (zeros on the CPU). Like :meth:`compiled_programs`, only
        after :meth:`close`."""
        out: Dict[int, dict] = {}
        for i, w in sorted(self._workers.items()):
            if w.alive():
                raise RuntimeError(
                    f"fleet: replica {i} still running; close() first")
            if w.engine is not None:
                progs = w.engine.programs.values()
                out[i] = {
                    "captured": sum(p.graph is not None for p in progs),
                    "replays": sum(p.replays for p in progs),
                    "capture_s": round(w.engine.capture_seconds, 6)}
        return out

    def report(self) -> dict:
        frs = sorted(self.requests.values(), key=lambda f: f.frid)
        real = [f for f in frs if not f.chaff]
        chaff = [f for f in frs if f.chaff]
        lats = sorted(f.latency_s for f in real
                      if f.status == DONE and f.latency_s is not None)
        p99 = lats[min(len(lats) - 1,
                       int(0.99 * len(lats)))] if lats else None
        return {
            "replicas_started": len(self._workers),
            "replicas": {
                i: {"dead": not w.alive(), "killed": w.killed,
                    "death": w.death, "restarts": w.restarts,
                    "stats": w.snapshot()}
                for i, w in sorted(self._workers.items())
            },
            "requests": len(real),
            "chaff": len(chaff),
            "done": sum(1 for f in real if f.status == DONE),
            "shed": sum(1 for f in real
                        if f.status is not None and f.status != DONE),
            "route": dict(self.route_counts),
            "failover_replayed": self.failover_replayed,
            "deaths": list(self.deaths),
            "storm_fired": list(self._storm_fired),
            "autoscale": list(self.autoscale_events),
            "p99_latency_s": p99,
        }


# -- CLI driver ---------------------------------------------------------------


def _fleet_workload(args, *, sessions: int, page_size: int) -> list:
    """Sessioned synthetic stream: ``sessions`` distinct full-page
    prefixes, each request is its session's prefix plus a ragged seeded
    suffix — so repeat visits to a session are affinity hits and first
    visits are fallbacks (the bench's anti-vacuity gates).

    Suffix lengths and token budgets follow one seeded *per-visit*
    schedule shared by every session, so sessions are work-identical by
    construction: any session-granular routing split carries the same
    decode load, and the throughput-scaling gate measures routing, not
    workload luck.  Token contents stay per-request random.
    """
    import numpy as np
    rng = np.random.default_rng(args.seed)
    prefixes = [rng.integers(0, args.vocab, size=page_size).tolist()
                for _ in range(sessions)]
    max_suffix = max(2, args.max_len // 8)
    visits = -(-args.requests // sessions)  # ceil
    suffix_lens = [int(rng.integers(1, max_suffix)) for _ in range(visits)]
    budgets = [int(rng.integers(args.min_new, args.max_new + 1))
               for _ in range(visits)]
    out = []
    for i in range(args.requests):
        s, v = i % sessions, i // sessions
        suffix = rng.integers(0, args.vocab, size=suffix_lens[v]).tolist()
        out.append({
            "session": s,
            "prompt": prefixes[s] + suffix,
            "max_new_tokens": budgets[v],
        })
    return out


def run_fleet(args) -> int:
    """``python -m tpu_dist_torch.serve --fleet``: run the sessioned
    workload through a fleet, compare every token stream against an
    uninterrupted solo baseline, and gate on routing/failover/pinning
    invariants. Token parity is equality on the CPU; on the card a stream
    may also leave the baseline's at a tie the full forward certifies
    (``serve/chaos.py``), counted in ``certified_ties``."""
    from tpu_dist_torch.serve.chaos import _certified_tie
    from tpu_dist_torch.serve.cli import _build_engine
    from tpu_dist_torch.utils.device import device_name

    if args.devices_per_replica is not None and args.devices_per_replica > 1:
        raise unported("a fleet replica of several devices in one process",
                       "12b")
    metrics.get_registry().reset()
    metrics.enable()
    plan = (FaultPlan.parse(args.plan)
            if getattr(args, "plan", None) else FaultPlan())
    foreign = sorted({f.kind for f in plan.faults
                      if f.kind not in FLEET_KINDS})
    if foreign:
        print(f"error: fault kind(s) {foreign} target a solo engine; "
              f"run them through --chaos, not --fleet", file=sys.stderr)
        return 2
    page_size = args.page_size
    sessions = max(1, int(args.fleet_sessions))
    workload = _fleet_workload(args, sessions=sessions, page_size=page_size)

    def factory(replica, *, journal, fault_injector):
        del replica
        return _build_engine(args, journal=journal,
                             fault_injector=fault_injector,
                             max_queue=args.max_queue,
                             retry_budget=args.retry_budget)

    # Uninterrupted solo baseline: greedy decode is batch-composition
    # independent, so per-request streams are the fleet's ground truth.
    print(f"fleet: baseline — solo engine, {len(workload)} requests")
    solo = _build_engine(args)
    solo_reqs = [solo.submit(w["prompt"],
                             max_new_tokens=w["max_new_tokens"])
                 for w in workload]
    solo.run_until_idle()
    baseline = [list(r.generated) for r in solo_reqs]
    solo_programs = solo.compiled_programs()
    solo_buckets = tuple(solo.scheduler.buckets)
    solo.close()

    workdir = getattr(args, "workdir", None)
    journal_root = os.path.join(workdir, "fleet-journals") if workdir else None
    fleet = ServeFleet(factory, replicas=args.fleet_replicas,
                       page_size=page_size, journal_root=journal_root,
                       plan=plan,
                       devices_per_replica=args.devices_per_replica,
                       storm_vocab=args.vocab, storm_seed=args.seed,
                       device=args.device)
    print(f"fleet: {args.fleet_replicas} replica(s), {sessions} session(s), "
          f"plan={'; '.join(describe_faults(plan)) if plan.faults else 'none'}")
    fleet.start()
    frs = [fleet.submit(w["prompt"], max_new_tokens=w["max_new_tokens"])
           for w in workload]
    fleet.drain(timeout_s=args.deadline)
    fleet.close()
    report = fleet.report()
    programs = fleet.compiled_programs()

    gates = {}
    # Every admitted (non-chaff) request reaches DONE.
    gates["all_done"] = all(fr.status == DONE for fr in frs)
    # Token parity with the uninterrupted solo baseline: bit-identical,
    # or on the card leaving it first at a certified tie.
    ties = []
    parity = True
    for fr, base in zip(frs, baseline):
        if fr.tokens == base:
            continue
        t = (_certified_tie(solo.model, solo.device, fr.prompt, base,
                            fr.tokens)
             if solo.device.type == "cuda" and len(fr.tokens) == len(base)
             else None)
        if t is None:
            parity = False
        else:
            ties.append({"frid": fr.frid, "token": t, "expected": base[t],
                         "got": fr.tokens[t]})
    gates["token_parity"] = parity
    # Survivors never restarted: blast radius zero.
    gates["survivors_zero_restarts"] = all(
        w.restarts == 0 for w in fleet._workers.values() if not w.killed)
    # Steady-state router adds no device programs.  With one healthy
    # replica the pin is exact: same workload, same order, so the
    # program dict must be bit-identical to the solo engine's.  With
    # N > 1 each replica sees a different concurrency profile (decode
    # buckets track active count), so the pin is containment in the
    # engine's *static* program universe — the configured bucket ladder
    # and the pow2 prompt-pad ladder — i.e. routing/failover never
    # introduces a program shape a solo engine could not compile.
    if args.fleet_replicas == 1 and not fleet._kill_faults:
        gates["no_new_programs"] = all(p == solo_programs
                                       for p in programs.values())
    else:
        universe = _program_universe(solo_buckets, args.max_len)
        gates["no_new_programs"] = all(
            _program_keys(p) <= universe for p in programs.values())
    if fleet._kill_faults:
        gates["kill_fired"] = any(d["killed"] for d in report["deaths"])
        gates["failover_replayed"] = report["failover_replayed"] >= 1
    if fleet._storm_faults:
        gates["storm_fired"] = bool(report["storm_fired"])
        chaff = [f for f in fleet.requests.values() if f.chaff]
        gates["storm_settled"] = bool(chaff) and all(
            f.status is not None for f in chaff)

    report["gates"] = gates
    report["device"] = device_name(solo.device)
    report["certified_ties"] = ties
    report["graphs"] = fleet.graph_stats()
    report["programs"] = {str(i): _program_summary(p)
                          for i, p in programs.items()}
    report["solo_programs"] = _program_summary(solo_programs)
    ok = all(gates.values())
    report["ok"] = ok
    out = json.dumps(report, indent=2, default=str)
    print(out)
    if getattr(args, "report", None):
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(out + "\n")
    print(f"fleet: {'OK' if ok else 'FAILED'} — "
          + ", ".join(f"{k}={'pass' if v else 'FAIL'}"
                      for k, v in gates.items()))
    return 0 if ok else 1


def _program_keys(programs: dict) -> set:
    """Flatten ``compiled_programs()``'s ``{kind: [keys...]}`` dict into
    a comparable set of ``(kind, key)`` pairs."""
    return {(kind, k) for kind, entries in programs.items()
            for k in entries}


def _program_universe(buckets: Sequence[int], max_len: int) -> set:
    """Every program shape a solo engine of this configuration could
    compile: decode programs per configured bucket, prefill programs per
    reachable pow2 prompt pad."""
    from tpu_dist_torch.serve.engine import _pad_to_pow2
    pads = {_pad_to_pow2(n, hi=max_len) for n in range(1, max_len + 1)}
    universe = set()
    for kind in ("decode", "paged_decode"):
        universe |= {(kind, b) for b in buckets}
    for kind in ("prefill", "paged_prefill", "prefill_chunk"):
        universe |= {(kind, p) for p in pads}
    return universe


def _program_summary(programs: dict) -> dict:
    return {kind: list(entries) for kind, entries in programs.items()}
