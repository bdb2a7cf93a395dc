"""shardcheck recorded checks — collective consistency on a fake group.

Counterpart of ``tpu_dist/analysis/jaxpr_checks.py``. The reference
traces each entry point once with ``jax.make_jaxpr`` and walks the SPMD
program XLA will partition; an eager PyTorch step has no such program, so
the port **records** it instead. :class:`CollectiveRecorder` is a
``TorchDispatchMode`` that logs, in order, every ``c10d`` op (each
collective and point-to-point launch, with its tensors' shapes and
dtypes, its process group's ranks and, for a send or recv, its peer) and
every random ``aten`` op, counts matmul/convolution FLOPs, and tracks
each tensor storage it sees created from its allocation to its last
reference (the cost model's peak live bytes).

Each entry point runs once per rank on a **fake process group** of the
entry's world size (``torch.distributed``'s ``fake`` backend: one process
plays rank r of N, every collective returns at once and moves nothing),
and twice per rank, under two input seeds. The rules compare the ranks'
recordings:

* **SC201** — the ranks of one group record different collective
  sequences on it (a collective under ``if rank == 0``).
* **SC202** — one rank's sequence changes length between the two seeds:
  a collective inside a loop whose trip count the data decides.
* **SC203** — the same position of a group's sequence carries another
  shape or dtype on another rank, or a send has no matching recv (or
  their bytes differ).
* **SC900** — an entry that does not run, naming its exception class.
* **SC610** rides the ``cost`` subcommand: each entry's random ``aten``
  ops against the committed baseline.

A fake group returns garbage where a real one returns the reduced data,
so an entry whose control flow reads a collective's result is recorded as
the data it happened to see; the registered entries' flow does not.

Register user programs by defining a module-level ``shardcheck_entry()``
that returns ``(fn, example_args)`` (or ``(fn, example_args, world)`` with
``fn(*args)`` run on each of ``world`` fake ranks); the CLI records it and
applies the same checks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import tempfile
import threading
import weakref
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_dist_torch.analysis.costmodel import matmul_flops
from tpu_dist_torch.analysis.rules import Finding

logger = logging.getLogger("tpu_dist_torch.analysis")

#: Input-tensor argument names of the ``c10d`` ops, in preference order:
#: the payload a rank puts on the wire.
_PAYLOAD_ARGS = ("input_tensors", "input_tensor", "input", "tensors",
                 "tensor")

#: ``aten`` op-name fragments that draw from a generator (SC610).
_RNG_FRAGMENTS = ("rand", "bernoulli", "normal", "multinomial", "uniform",
                  "exponential", "poisson", "cauchy", "geometric",
                  "log_normal", "random_", "dropout")


def _cause(e: BaseException, limit: int = 160) -> str:
    """``ExceptionType: first line of the message``."""
    first = (str(e).splitlines() or [""])[0].strip()
    if len(first) > limit:
        first = first[:limit - 1] + "…"
    return f"{type(e).__name__}: {first}" if first else type(e).__name__


def _tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        out = []
        for v in value:
            out.extend(_tensors(v))
        return out
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded ``c10d`` launch or random ``aten`` op."""

    op: str  # c10d op name without namespace/overload, or the aten op
    kind: str  # "collective", "p2p" or "random"
    shapes: tuple  # ((shape, dtype), ...) of the payload tensors
    group: tuple = ()  # global ranks of the process group
    peer: Optional[int] = None  # global peer rank of a send/recv
    payload_bytes: int = 0
    axis: Optional[str] = None  # the mesh axis the group is, if known


@dataclasses.dataclass
class Recording:
    """What :class:`CollectiveRecorder` logged for one rank's run."""

    rank: int = 0
    world: int = 1
    events: list = dataclasses.field(default_factory=list)
    peak_live_bytes: int = 0
    flops: int = 0

    def comm_events(self) -> list:
        return [e for e in self.events if e.kind != "random"]

    def collectives(self) -> list:
        return [e for e in self.events if e.kind == "collective"]

    def random_ops(self) -> list:
        return sorted({e.op for e in self.events if e.kind == "random"})

    def collective_counts(self) -> dict:
        """``{(op, shape, dtype): count}`` over the communication events."""
        out: dict = {}
        for e in self.comm_events():
            shape, dtype = e.shapes[0] if e.shapes else ((), "")
            key = (e.op, tuple(shape), dtype)
            out[key] = out.get(key, 0) + 1
        return out


class CollectiveRecorder(TorchDispatchMode):
    """Record every ``c10d`` op and random ``aten`` op dispatched while
    active, and the lifetimes of the storages created on ``device``.

    ``axis_of`` maps a group's global ranks (a tuple) to a mesh axis name
    for the cost model. Runs the ops as they are: under the recorder a
    step computes exactly what it computes without it. Thread-safe: the
    autograd engine may run a backward's ops on its own thread."""

    def __init__(self, device="cpu", *, axis_of: Optional[dict] = None,
                 rank: int = 0, world: int = 1):
        super().__init__()
        self.device = torch.device(device)
        self.axis_of = dict(axis_of or {})
        self.recording = Recording(rank=rank, world=world)
        # Reentrant: a storage's finalizer (``_free``) may run while this
        # thread holds the lock, when the recorder drops a reference.
        self._lock = threading.RLock()
        self._live: dict = {}  # storage key -> bytes
        self._live_bytes = 0

    # -- lifetimes -----------------------------------------------------------

    def _track(self, out) -> None:
        want = self.device
        for t in _tensors(out):
            if t.device.type != want.type or (
                    want.index is not None and t.device.index != want.index):
                continue
            try:
                storage = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            size = storage.nbytes()
            key = storage.data_ptr() if size else None
            if key is None or key in self._live:
                continue
            self._live[key] = size
            self._live_bytes += size
            self.recording.peak_live_bytes = max(
                self.recording.peak_live_bytes, self._live_bytes)
            weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        with self._lock:
            self._live_bytes -= self._live.pop(key, 0)

    # -- events --------------------------------------------------------------

    def _c10d(self, func, args, kwargs) -> None:
        named = {a.name: v for a, v in zip(func._schema.arguments, args)}
        named.update(kwargs)
        name = func.__name__.split(".")[0]
        pg = named.get("process_group")
        group = (tuple(dist.get_process_group_ranks(
            dist.ProcessGroup.unbox(pg))) if pg is not None else ())
        payload = []
        for arg in _PAYLOAD_ARGS:
            if arg in named:
                payload = _tensors(named[arg])
                break
        if name == "barrier":
            payload = []
        peer = None
        kind = "collective"
        if name in ("send", "recv_", "recv_any_source_"):
            kind = "p2p"
            local = named.get("dst", named.get("src"))
            if local is not None and group:
                peer = group[int(local)]
        self.recording.events.append(Event(
            op=name, kind=kind,
            shapes=tuple((tuple(t.shape), str(t.dtype).replace(
                "torch.", "")) for t in payload),
            group=group, peer=peer,
            payload_bytes=sum(_nbytes(t) for t in payload),
            axis=self.axis_of.get(group)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        namespace = func.namespace
        if namespace == "c10d":
            with self._lock:
                self._c10d(func, args, kwargs)
        out = func(*args, **kwargs)
        if namespace == "aten":
            op = str(func)
            with self._lock:
                if any(f in op for f in _RNG_FRAGMENTS):
                    self.recording.events.append(Event(
                        op=op, kind="random", shapes=()))
                shapes = [tuple(t.shape) for t in _tensors(list(args))]
                flops = matmul_flops(op, shapes)
                if not flops:
                    flops = sum(t.numel() for t in _tensors(out))
                self.recording.flops += flops
                self._track(out)
        return out


# -- fake process groups ---------------------------------------------------------

def _fake_store():
    """The ``fake`` backend's store (importing its module registers the
    backend)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


@contextlib.contextmanager
def fake_group(rank: int, world: int, device="cpu"):
    """A ``fake`` process group in which this process is ``rank`` of
    ``world`` (nothing with ``world == 1``): collectives return at once
    and move nothing. The port's bootstrap sees a group on ``device``; the
    liveness monitor starts no threads; every mesh subgroup made under it
    is forgotten on exit."""
    if world <= 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; record on a "
                           "process without one")
    from tpu_dist_torch.cluster import bootstrap, liveness
    from tpu_dist_torch.parallel import mesh as mesh_lib

    saved = (bootstrap._DEVICE, liveness._shared_monitor,
             dict(mesh_lib._GROUPS), list(mesh_lib._MADE))
    dist.init_process_group("fake", store=_fake_store(), rank=rank,
                            world_size=world)
    bootstrap._DEVICE = torch.device(device)
    liveness._shared_monitor = _monitor_without_threads()
    try:
        yield
    finally:
        dist.destroy_process_group()
        (bootstrap._DEVICE, liveness._shared_monitor) = saved[:2]
        mesh_lib._GROUPS.clear()
        mesh_lib._GROUPS.update(saved[2])
        mesh_lib._MADE[:] = saved[3]


def _monitor_without_threads():
    """A liveness monitor that never starts: a fake group has no peer to
    probe."""
    from tpu_dist_torch.cluster.liveness import LivenessMonitor

    class NoThreads(LivenessMonitor):
        def start(self):
            return self

    return NoThreads()


def axis_map(axis_shapes: Optional[dict]) -> dict:
    """``{group ranks: axis}`` for a mesh over the processes in row-major
    order (``parallel/mesh.py``): each slice of each axis, and the whole
    world for an axis that spans it."""
    if not axis_shapes:
        return {}
    names, sizes = list(axis_shapes), list(axis_shapes.values())
    ranks = np.arange(math.prod(sizes)).reshape(sizes)
    out = {}
    for k, name in enumerate(names):
        if sizes[k] == 1:
            continue
        for row in np.moveaxis(ranks, k, -1).reshape(-1, sizes[k]):
            out[tuple(int(r) for r in row)] = name
    return out


def record(fn: Callable, *args, device="cpu", axis_of=None, rank: int = 0,
           world: int = 1) -> Recording:
    """Run ``fn(*args)`` under a :class:`CollectiveRecorder` and return
    what it logged."""
    with CollectiveRecorder(device, axis_of=axis_of, rank=rank,
                            world=world) as rec:
        fn(*args)
    return rec.recording


# -- the checks ------------------------------------------------------------------

def _group_sequences(recordings: dict) -> dict:
    """``{group: {rank: [event, ...]}}`` of the collectives."""
    out: dict = {}
    for rank, rec in recordings.items():
        for ev in rec.collectives():
            out.setdefault(ev.group, {}).setdefault(rank, []).append(ev)
    return out


def check_group_collectives(recordings: dict, *, label: str,
                            path: str = "<trace>") -> list[Finding]:
    """SC201/SC203a: the ranks of every group must record the same
    collective sequence on it, over the same shapes and dtypes.
    ``recordings`` maps rank -> :class:`Recording` of one seed."""
    findings: list[Finding] = []
    for group, per_rank in sorted(_group_sequences(recordings).items()):
        members = [r for r in group if r in recordings]
        seqs = {r: per_rank.get(r, []) for r in members}
        orders = {r: tuple(e.op for e in s) for r, s in seqs.items()}
        if len(set(orders.values())) > 1:
            desc = ", ".join(f"rank {r}: {list(o) or ['<none>']}"
                             for r, o in sorted(orders.items()))
            findings.append(Finding(
                "SC201", path, 1, 0,
                f"{label}: ranks {list(group)} record different collective "
                f"sequences on their group ({desc}); the ranks launching a "
                "different collective deadlock — hoist it out of the "
                "rank-dependent branch"))
            continue
        sigs = {r: tuple(e.shapes for e in s) for r, s in seqs.items()}
        if len(set(sigs.values())) > 1:
            first = next(i for i, xs in enumerate(zip(*sigs.values()))
                         if len(set(xs)) > 1)
            desc = ", ".join(
                f"rank {r}: {s[first]}" for r, s in sorted(sigs.items()))
            findings.append(Finding(
                "SC203", path, 1, 0,
                f"{label}: the {orders[members[0]][first]} at position "
                f"{first} of group {list(group)}'s sequence carries "
                f"different payloads ({desc}); the rendezvous pairs "
                "mismatched shapes/dtypes — hang or garbage"))
    return findings


def check_point_to_point(recordings: dict, *, label: str,
                         path: str = "<trace>") -> list[Finding]:
    """SC203b: every send of rank s to rank d must meet a recv of rank d
    from rank s, in order, with the same bytes."""
    sends: dict = {}
    recvs: dict = {}
    for rank, rec in recordings.items():
        for ev in rec.events:
            if ev.kind != "p2p" or ev.peer is None:
                continue
            if ev.op == "send":
                sends.setdefault((rank, ev.peer), []).append(ev)
            else:
                recvs.setdefault((ev.peer, rank), []).append(ev)
    findings: list[Finding] = []
    for pair in sorted(set(sends) | set(recvs)):
        src, dst = pair
        if src not in recordings or dst not in recordings:
            continue
        s, r = sends.get(pair, []), recvs.get(pair, [])
        if len(s) != len(r):
            findings.append(Finding(
                "SC203", path, 1, 0,
                f"{label}: rank {src} sends {len(s)} time(s) to rank {dst}, "
                f"which receives {len(r)} time(s) from it; the unpaired "
                "side blocks forever"))
            continue
        for i, (a, b) in enumerate(zip(s, r)):
            if a.payload_bytes != b.payload_bytes:
                findings.append(Finding(
                    "SC203", path, 1, 0,
                    f"{label}: send {i} of rank {src} to rank {dst} carries "
                    f"{a.payload_bytes} B {list(a.shapes)} but the recv "
                    f"expects {b.payload_bytes} B {list(b.shapes)}"))
                break
    return findings


def check_trip_counts(by_seed: dict, *, label: str,
                      path: str = "<trace>") -> list[Finding]:
    """SC202: one rank's communication count changes between seeds.
    ``by_seed`` maps seed -> {rank: Recording}."""
    findings: list[Finding] = []
    seeds = sorted(by_seed)
    if len(seeds) < 2:
        return findings
    ranks = sorted(set.intersection(*(set(by_seed[s]) for s in seeds)))
    for rank in ranks:
        counts = {s: len(by_seed[s][rank].comm_events()) for s in seeds}
        if len(set(counts.values())) > 1:
            ops = sorted({e.op for s in seeds
                          for e in by_seed[s][rank].comm_events()})
            findings.append(Finding(
                "SC202", path, 1, 0,
                f"{label}: rank {rank} launches {counts} communication "
                f"op(s) by input seed ({', '.join(ops)}); the trip count "
                "is data-dependent, so ranks whose data differ deadlock — "
                "bound the loop by a rank-uniform count, or hoist the "
                "collective out"))
            break
    return findings


def check_trace(by_seed: dict, *, label: str,
                path: str = "<trace>") -> list[Finding]:
    """Every recorded rule over one entry's recordings (``{seed: {rank:
    Recording}}``): SC201/SC203 per seed, SC202 across seeds. The
    counterpart of the reference's ``check_jaxpr``."""
    findings: list[Finding] = []
    first = by_seed[min(by_seed)]
    findings.extend(check_group_collectives(first, label=label, path=path))
    findings.extend(check_point_to_point(first, label=label, path=path))
    findings.extend(check_trip_counts(by_seed, label=label, path=path))
    return findings


#: The reference's names for the two rules: what a rank-dependent branch
#: does shows in the ranks' recordings (SC201/SC203), what a
#: data-dependent loop does shows across seeds (SC202).
check_branch_collectives = check_group_collectives
check_while_collectives = check_trip_counts


def collective_sequence(recording: Recording) -> list[str]:
    """The recording's communication ops in launch order, each with its
    group's axis (or ranks)."""
    out = []
    for e in recording.comm_events():
        where = e.axis or ",".join(map(str, e.group))
        out.append(f"{e.op}[{where}]")
    return out


def rng_primitives(recording: Recording) -> list[str]:
    """Sorted random ``aten`` ops the recording drew (SC610's set)."""
    return recording.random_ops()


def check_rng_baseline(rng_now: dict, rng_baseline: dict,
                       path: str) -> list:
    """SC610: a recorded entry whose committed baseline records ZERO random
    ops now draws one; drift in an entry that already draws is SC900."""
    findings: list[Finding] = []
    for name in sorted(rng_now):
        if name not in rng_baseline:
            continue
        before, after = list(rng_baseline[name]), list(rng_now[name])
        if before == after:
            continue
        if not before and after:
            findings.append(Finding(
                "SC610", path, 1, 0,
                f"{name}: baseline records this step as RNG-FREE, but it "
                f"now draws {', '.join(after)}; a contractually "
                f"deterministic step grew a random stream — remove it, or "
                f"re-run cost --update-baseline only if the contract "
                f"itself changed"))
        else:
            findings.append(Finding(
                "SC900", path, 1, 0,
                f"{name}: random op set drifted from baseline "
                f"({', '.join(before) or 'none'} -> "
                f"{', '.join(after) or 'none'}); if intended, re-run "
                f"cost --update-baseline and commit the diff"))
    return findings


# -- running entries -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """A registered entry: ``setup(rank, seed)`` builds this rank's state
    (outside the recorder) and returns the step to record; it runs on
    ``world`` fake ranks whose mesh is ``axis_shapes``."""

    setup: Callable
    world: int = 1
    axis_shapes: Optional[dict] = None


SEEDS = (0, 1)


def run_entry(entry: EntryPoint, *, device="cpu",
              seeds: Iterable[int] = SEEDS) -> dict:
    """``{seed: {rank: Recording}}`` of one entry point."""
    axis_of = axis_map(entry.axis_shapes)
    out: dict = {}
    for seed in seeds:
        for rank in range(entry.world):
            with fake_group(rank, entry.world):
                torch.manual_seed(seed)
                step = entry.setup(rank, seed)
                out.setdefault(seed, {})[rank] = record(
                    step, device=device, axis_of=axis_of, rank=rank,
                    world=entry.world)
    return out


def check_callable(fn: Callable, args: tuple, *, label: str,
                   path: str = "<trace>", world: int = 1) -> list[Finding]:
    """Record ``fn(*args)`` on each of ``world`` fake ranks under two seeds
    and run every recorded rule on the result."""
    entry = EntryPoint(lambda rank, seed: (lambda: fn(*args)), world)
    return check_trace(run_entry(entry), label=label, path=path)


# -- built-in entry points -------------------------------------------------------

def _probe_model(**compile_kw):
    from tpu_dist_torch.models import Dense, Sequential

    model = Sequential([Dense(4)], input_shape=(4,),
                       name="shardcheck_probe")
    model.compile(optimizer="sgd", loss="mse", device="cpu", **compile_kw)
    return model


def _step_of(model, x, y, *, health=False):
    """The trainer's step of a compiled model over one batch."""
    trainer = model._get_trainer("fit")
    trainer.ensure_variables()
    state = trainer.train_state()
    stepper = trainer._step()
    if health:
        from tpu_dist_torch.training.integrity import StepHealth

        stepper = trainer._step(health=StepHealth(state[0]))
    return lambda: stepper(*state, x, y)


def _batch(seed: int, shape, *, labels=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if labels is None:
        y = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    else:
        y = torch.from_numpy(rng.integers(0, labels, shape[0]))
    return x, y


def _strategy(axis_shapes=None):
    from tpu_dist_torch.parallel.strategy import MultiWorkerMirroredStrategy

    return MultiWorkerMirroredStrategy(communication="ring", device="cpu",
                                       axis_shapes=axis_shapes)


def _setup_train_step(rank, seed):
    x, y = _batch(seed, (8, 4))
    return _step_of(_probe_model(), x, y)


def _setup_train_step_bucketed(rank, seed):
    """Gradient buckets of one leaf each (``gradient_bucket_bytes=1``) over
    eight data-parallel ranks, as the reference's probe over 8 devices."""
    with _strategy().scope():
        model = _probe_model(gradient_bucket_bytes=1)
    x, y = _batch(seed, (8, 4))
    return _step_of(model, x, y)


def _setup_train_step_prefetch(rank, seed):
    x, y = _batch(seed, (8, 4))
    return _step_of(_probe_model(prefetch_to_device=2), x, y)


def _cnn_step(seed, *, health=False):
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model

    model = build_and_compile_cnn_model(learning_rate=0.01, device="cpu")
    x, y = _batch(seed, (8, 28, 28, 1), labels=10)
    return _step_of(model, x, y, health=health)


def _setup_resilience_demo_step(rank, seed):
    return _cnn_step(seed)


def _setup_observe_demo_step(rank, seed):
    """The demo step with telemetry armed: the collective observe hook is
    installed while it runs, which must add no collective."""
    from tpu_dist_torch.observe.metrics import MetricsRegistry
    from tpu_dist_torch.observe.telemetry import registry_collective_hook
    from tpu_dist_torch.parallel import collectives

    step = _cnn_step(seed)

    def run():
        prev = collectives.install_observe_hook(
            registry_collective_hook(MetricsRegistry(enabled=True)))
        try:
            step()
        finally:
            collectives.install_observe_hook(prev)

    return run


def _setup_megatron_block(rank, seed):
    """The Megatron MLP over a 4-way model axis (parallel/tensor.py's f and
    g pair): column-parallel up-projection, row-parallel down-projection,
    one all-reduce of the partial sums, at the reference entry's shapes."""
    from tpu_dist_torch.parallel import mesh as mesh_lib
    from tpu_dist_torch.parallel import tensor

    mesh = mesh_lib.make_mesh({"model": 4}, device="cpu")
    shard = tensor.ModelShard(mesh_lib.axis_group(mesh, "model"), 4,
                              mesh_lib.coordinate(mesh, "model"))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    w1 = torch.ones(8, 32 // 4)
    w2 = torch.ones(32 // 4, 8)

    def block():
        h = torch.relu(shard.copy(x) @ w1)
        return shard.reduce(h @ w2)

    return block


def _setup_ring_attention(rank, seed):
    """Causal ring attention over a 4-way seq axis (parallel/sequence.py)
    on the reference entry's ``[2, 2, 16, 4]`` q/k/v."""
    from tpu_dist_torch.parallel import mesh as mesh_lib
    from tpu_dist_torch.parallel.sequence import ring_attention

    mesh = mesh_lib.make_mesh({"seq": 4}, device="cpu")
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 2, 16, 4)).astype(np.float32))
    return lambda: ring_attention(q, q, q, mesh=mesh, causal=True)


def _setup_moe_layer(rank, seed):
    """MixtureOfExperts under a data x expert strategy (2 x 4): the
    all_to_all dispatch and return plus the aux-loss means."""
    from tpu_dist_torch.models import Sequential
    from tpu_dist_torch.parallel.expert import MixtureOfExperts

    with _strategy({"data": 2, "expert": 4}).scope():
        model = Sequential([MixtureOfExperts(num_experts=4, ff_dim=16,
                                             top_k=2)],
                           input_shape=(8, 8), seed=0)
        model.compile(loss="mse", optimizer="sgd", device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 8, 8)).astype(np.float32))
    return lambda: model(x)


def _setup_checkpoint_snapshot(rank, seed):
    """The async checkpointer's snapshot of a compiled trainer's saveable
    state (training/checkpoint.py ``_Snapshot``): collective-free."""
    from tpu_dist_torch.training import checkpoint

    model = _probe_model()
    model._get_trainer("fit").ensure_variables()
    saveable = checkpoint._saveable(model)
    return lambda: checkpoint._Snapshot(saveable).arrays()


def _serve_probe(*, int8=False, paged=False):
    from tpu_dist_torch.models.transformer import build_transformer_lm
    from tpu_dist_torch.serve import kv_cache

    model = build_transformer_lm(32, 16, d_model=16, depth=1, num_heads=2)
    model.eval()
    plan = kv_cache.build_plan(model)
    if paged:
        return plan, kv_cache.init_page_pool(
            plan, num_pages=8, page_size=4, device="cpu",
            dtype=torch.int8 if int8 else torch.float32)
    return plan, kv_cache.init_cache(plan, max_batch=4, max_len=16,
                                     device="cpu")


def _tokens(seed, n):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 32, n).astype(np.int64))


def _no_grad(fn):
    def run():
        with torch.no_grad():
            return fn()
    return run


def _setup_serve_prefill(rank, seed):
    from tpu_dist_torch.serve import kv_cache

    plan, cache = _serve_probe()
    t = _tokens(seed, 8)
    return _no_grad(lambda: kv_cache.prefill(plan, cache, t, 5, 0))


def _setup_serve_decode(rank, seed):
    from tpu_dist_torch.serve import kv_cache

    plan, cache = _serve_probe()
    t, lengths = _tokens(seed, 4), torch.ones(4, dtype=torch.int64)
    return _no_grad(lambda: kv_cache.decode_step(plan, cache, t, lengths,
                                                 bucket=4))


def _setup_serve_prefill_chunk(rank, seed):
    from tpu_dist_torch.serve import kv_cache

    plan, cache = _serve_probe()
    t = _tokens(seed, 8)
    return _no_grad(lambda: kv_cache.prefill_chunk_step(
        plan, cache, t, 12, 0, 8))


def _paged_prefill(seed, *, int8=False, n=8, length=5, start=0):
    from tpu_dist_torch.serve import kv_cache

    plan, pool = _serve_probe(paged=True, int8=int8)
    row = torch.arange(4, dtype=torch.int64)
    t = _tokens(seed, n)
    return _no_grad(lambda: kv_cache.paged_prefill(
        plan, pool, row, t, length, start))


def _paged_decode(seed, *, int8=False, ragged=False):
    from tpu_dist_torch.serve import kv_cache

    plan, pool = _serve_probe(paged=True, int8=int8)
    tables = torch.arange(16, dtype=torch.int64).reshape(4, 4) % 8
    t, lengths = _tokens(seed, 4), torch.ones(4, dtype=torch.int64)
    if ragged:
        active = torch.ones(4, dtype=torch.bool)
        return _no_grad(lambda: kv_cache.paged_decode_ragged(
            plan, pool, tables, t, lengths, active))
    return _no_grad(lambda: kv_cache.paged_decode_step(
        plan, pool, tables, t, lengths, bucket=4))


def _setup_integrity_health_step(rank, seed):
    from tpu_dist_torch.training import integrity

    model = _probe_model()
    x, y = _batch(seed, (8, 4))
    trainer = model._get_trainer("fit")
    trainer.ensure_variables()
    state = trainer.train_state()
    step = trainer._step(health=integrity.StepHealth(state[0]))
    return lambda: step(*state, x, y)


def _setup_integrity_audit_checksum(rank, seed):
    """The SDC audit's per-replica checksums (``leaf_checksums``): the
    device work of an audit, collective-free."""
    from tpu_dist_torch.training.integrity import leaf_checksums

    model = _probe_model()
    leaves = list(model.parameters())
    return lambda: leaf_checksums(leaves)


def _setup_integrity_audit_checksum_sharded(rank, seed):
    """The shard-aware audit on a ``{data: 4, model: 2}`` mesh: each rank
    checksums its own blocks of the Megatron layout's leaves
    (column-parallel kernel, sharded bias, replicated bias, row-parallel
    kernel) and gathers the ``[2, n]`` table of checksums and shard keys
    (``IntegrityGuard.audit``). The reference compares its devices'
    checksums in one process with no collective; one device a process
    makes the gather real communication."""
    from tpu_dist_torch.parallel import collectives
    from tpu_dist_torch.parallel import mesh as mesh_lib
    from tpu_dist_torch.training.integrity import leaf_checksums

    mesh = mesh_lib.make_mesh({"data": 4, "model": 2}, device="cpu")
    i = mesh_lib.coordinate(mesh, "model")
    leaves = [torch.zeros(8)[4 * i:4 * i + 4],
              torch.zeros(4, 8)[:, 4 * i:4 * i + 4],
              torch.zeros(4),
              torch.zeros(8, 4)[4 * i:4 * i + 4]]
    keys = np.asarray([1 + i, 1 + i, 0, 1 + i], np.int64)

    def audit():
        local = np.stack([leaf_checksums(leaves).numpy(), keys])
        return collectives.host_all_gather(local)

    return audit


def _setup_ps_worker_step(rank, seed):
    """The asynchronous PS worker's local step (forward and backward, no
    update, no collective)."""
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
    from tpu_dist_torch.parallel.ps_strategy import ParameterServerStrategy

    strategy = ParameterServerStrategy(
        tempfile.mkdtemp(prefix="shardcheck-psw-"), role="worker", rank=0,
        num_workers=1, staleness=4, sync=False, device="cpu")
    with strategy.scope():
        model = build_and_compile_cnn_model(learning_rate=0.01,
                                            device="cpu")
    trainer = model._get_trainer("fit")
    trainer.ensure_variables()
    step = trainer._build_ps_worker_step()
    x, y = _batch(seed, (8, 28, 28, 1), labels=10)
    return lambda: step(x, y)


def _setup_ps_server_apply(rank, seed):
    """The PS server's apply: one pushed gradient folded into the
    parameters through the model's optimizer (``PSServer``)."""
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
    from tpu_dist_torch.parallel.ps_strategy import PSServer

    model = build_and_compile_cnn_model(learning_rate=0.01, device="cpu")
    server = PSServer(model, PSDir(tempfile.mkdtemp(
        prefix="shardcheck-pss-")), num_workers=1, budget=1)
    params = server._params
    grads = [torch.zeros_like(p) for p in params]
    opt = server.trainer.variables["opt"]

    def apply():
        with torch.no_grad():
            server.model.optimizer.update(grads, opt, params)

    return apply


def _job(kind):
    from tpu_dist_torch.jobs.runtime import MeshRuntime, job_scope
    from tpu_dist_torch.jobs.spec import JobSpec

    return job_scope(MeshRuntime(["cpu"]),
                     JobSpec(name=f"shardcheck-{kind}-job", kind=kind,
                             devices=1))


def _setup_jobs_runtime_train_step(rank, seed):
    """The probe model's step built inside a multi-tenant job scope: the
    solo no-op contract from the program side."""
    with _job("train"):
        model = _probe_model()
        x, y = _batch(seed, (8, 4))
        return _step_of(model, x, y)


def _setup_jobs_runtime_decode_step(rank, seed):
    from tpu_dist_torch.serve import kv_cache

    with _job("serve"):
        plan, cache = _serve_probe()
    t, lengths = _tokens(seed, 4), torch.ones(4, dtype=torch.int64)
    return _no_grad(lambda: kv_cache.decode_step(plan, cache, t, lengths,
                                                 bucket=4))


def _setup_gpipe(rank, seed):
    """The GPipe loop over a 2-stage pipe axis (parallel/
    pipeline_parallel.py) on the reference entry's ``[4, 2, 3]``
    microbatches: every valid tick's handoff."""
    from tpu_dist_torch.parallel import mesh as mesh_lib
    from tpu_dist_torch.parallel.pipeline_parallel import gpipe_schedule

    mesh = mesh_lib.make_mesh({"pipe": 2}, device="cpu")
    params = torch.ones(())
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 2, 3)).astype(np.float32))
    return lambda: gpipe_schedule(lambda p, a, g: a * p, params, x,
                                  num_stages=2, mesh=mesh)


def _setup_1f1b(rank, seed):
    """The hand-scheduled 1F1B step (parallel/pipeline_1f1b.py) of a
    two-stage pipelined LM: the port's 1F1B drives a pipelined model, not
    the reference's scalar stage functions."""
    from tpu_dist_torch.models.transformer import build_transformer_lm
    from tpu_dist_torch.parallel.pipeline_1f1b import make_1f1b_train_step

    strategy = _strategy({"data": 1, "pipe": 2})
    with strategy.scope():
        model = build_transformer_lm(32, 8, d_model=8, depth=2,
                                     num_heads=2, pipeline_stages=2,
                                     pipeline_microbatches=4)
        model.compile(loss="sparse_categorical_crossentropy",
                      optimizer="sgd", device="cpu")
    step = make_1f1b_train_step(model, model.loss, strategy=strategy)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 32, (4, 8)).astype(np.int64))
    y = torch.from_numpy(rng.integers(0, 32, (4, 8)).astype(np.int64))
    return lambda: step(x, y)


#: The reference's ``ENTRY_POINTS``, name for name, each recorded on the
#: port's own modules at the reference tracer's shapes and mesh.
ENTRY_POINTS = {
    "pipeline_parallel.gpipe_schedule": EntryPoint(
        _setup_gpipe, 2, {"pipe": 2}),
    "pipeline_1f1b.one_f_one_b": EntryPoint(
        _setup_1f1b, 2, {"data": 1, "pipe": 2}),
    "training.trainer.train_step": EntryPoint(_setup_train_step),
    "training.trainer.train_step_bucketed": EntryPoint(
        _setup_train_step_bucketed, 8, {"data": 8}),
    "training.trainer.train_step_prefetch": EntryPoint(
        _setup_train_step_prefetch),
    "resilience.entrypoints.demo_train_step": EntryPoint(
        _setup_resilience_demo_step),
    "observe.demo_train_step": EntryPoint(_setup_observe_demo_step),
    "parallel.tensor.megatron_block": EntryPoint(
        _setup_megatron_block, 4, {"model": 4}),
    "parallel.sequence.ring_attention": EntryPoint(
        _setup_ring_attention, 4, {"seq": 4}),
    "parallel.expert.moe_layer": EntryPoint(
        _setup_moe_layer, 8, {"data": 2, "expert": 4}),
    "training.checkpoint.snapshot_copy": EntryPoint(
        _setup_checkpoint_snapshot),
    "serve.prefill_step": EntryPoint(_setup_serve_prefill),
    "serve.decode_step": EntryPoint(_setup_serve_decode),
    "serve.paged_prefill": EntryPoint(
        lambda rank, seed: _paged_prefill(seed)),
    "serve.paged_decode_step": EntryPoint(
        lambda rank, seed: _paged_decode(seed)),
    "serve.prefill_chunk_step": EntryPoint(_setup_serve_prefill_chunk),
    "serve.paged_prefill_chunk": EntryPoint(
        lambda rank, seed: _paged_prefill(seed, n=4, length=8, start=4)),
    "serve.paged_decode_ragged": EntryPoint(
        lambda rank, seed: _paged_decode(seed, ragged=True)),
    "serve.paged_prefill_int8": EntryPoint(
        lambda rank, seed: _paged_prefill(seed, int8=True)),
    "serve.paged_decode_int8": EntryPoint(
        lambda rank, seed: _paged_decode(seed, int8=True)),
    "serve.paged_decode_ragged_int8": EntryPoint(
        lambda rank, seed: _paged_decode(seed, int8=True, ragged=True)),
    "training.integrity.health_step": EntryPoint(
        _setup_integrity_health_step),
    "training.integrity.audit_checksum": EntryPoint(
        _setup_integrity_audit_checksum),
    "training.integrity.audit_checksum_sharded": EntryPoint(
        _setup_integrity_audit_checksum_sharded, 8,
        {"data": 4, "model": 2}),
    "jobs.runtime.train_step": EntryPoint(_setup_jobs_runtime_train_step),
    "jobs.runtime.decode_step": EntryPoint(_setup_jobs_runtime_decode_step),
    "parallel.ps_strategy.ps_worker_step": EntryPoint(
        _setup_ps_worker_step),
    "parallel.ps_strategy.ps_server_apply": EntryPoint(
        _setup_ps_server_apply),
}


def record_entry_points(names: Optional[Iterable[str]] = None, *,
                        seeds: Iterable[int] = SEEDS
                        ) -> tuple[dict, list]:
    """Record every built-in entry point. Returns ``(recorded,
    findings)``: ``recorded`` maps name -> ``{seed: {rank: Recording}}``;
    an entry that cannot run here degrades to an SC900 info finding
    naming its exception class."""
    recorded: dict = {}
    findings: list[Finding] = []
    for name, entry in ENTRY_POINTS.items():
        if names is not None and name not in names:
            continue
        try:
            recorded[name] = run_entry(entry, seeds=seeds)
        except Exception as e:  # noqa: BLE001 - degrade, never crash
            logger.debug("entry point %s unrecordable", name, exc_info=True)
            findings.append(Finding(
                "SC900", f"<entry:{name}>", 1, 0,
                f"entry point {name} could not be recorded here "
                f"({_cause(e)}); its collective rules were skipped"))
    return recorded, findings


def run_entry_points(names: Optional[Iterable[str]] = None) -> list[Finding]:
    """Record every built-in entry point and collect the recorded rules'
    findings (SC900 for an entry that cannot run)."""
    recorded, findings = record_entry_points(names)
    for name, by_seed in recorded.items():
        findings.extend(check_trace(by_seed, label=name,
                                    path=f"<entry:{name}>"))
    return findings
