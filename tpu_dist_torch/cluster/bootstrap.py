"""Runtime bootstrap: cluster bring-up on ``torch.distributed``.

Counterpart of the bring-up part of ``tpu_dist/cluster/bootstrap.py``
(``initialize``, ``process_index``, ``process_count``, ``is_chief``,
``barrier``, ``cluster_config``). The JAX package dials the JAX
coordination service; here :func:`initialize` parses the same TF_CONFIG
and calls ``torch.distributed.init_process_group``:

* the rendezvous is process 0's declared address
  (``init_method="tcp://host:port"``), the rank is the task's global
  process id, the world size the number of tasks;
* the backend follows the communication mode (:func:`backend_for`): AUTO is NCCL when the process
  trains on CUDA and gloo when it trains on the CPU (``device="cpu"``),
  RING is gloo on either (gloo takes CUDA tensors, staging them through
  the host), NCCL is NCCL and raises on the CPU; never switched silently;
* on CUDA a process takes the local device whose index is the number of
  tasks declared before it on its host. NCCL cannot place two ranks on one
  device, so under NCCL more ranks on a host than it has cards raises;
  under gloo they share the cards in turn (index modulo the card count),
  which is how two workers train on one card;
* one process without a cluster (no TF_CONFIG, or a single task) creates no
  process group: the one-worker local mode, where every collective is the
  identity.

The call blocks until every process has joined, the reference's "training
begins when all servers are ready".

The gang-generation protocol of the JAX package's elasticity (item 18b)
keeps the reference's names and files, a contract on disk that either
package reads: :func:`current_generation` (``$TPU_DIST_GANG_GENERATION``),
the shared-directory barriers (:func:`epoch_rendezvous`,
:func:`generation_rendezvous`: ``{namespace}.{epoch|step}-N.rank-R``
markers, reaped on timeout and from older namespaces), and the
torn-read-tolerant reform files (:func:`request_reform`,
:func:`ack_reform`, :func:`publish_restore_step`,
:func:`publish_generation` and their readers). :func:`reinitialize` is
the one part with its own shape: with no process group up (a file gang of
single-process workers) it re-stamps the generation, as the reference
does; with one up it destroys the group and brings a new one up on
``host:(base port + generation)``, then rebuilds the mesh subgroups every
registered hook owns (:func:`on_reinitialize`), so no stale group object
outlives the clique it belonged to.
"""

from __future__ import annotations

import atexit
import logging
import os
import pathlib
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_dist_torch.cluster.config import ClusterConfig
from tpu_dist_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("tpu_dist_torch")

_STATE_LOCK = threading.Lock()
_CONFIG: Optional[ClusterConfig] = None
#: The device this process trains on once a process group is up.
_DEVICE: Optional[torch.device] = None
#: ``{backend, host, base_port, world_size, rank}`` of the process group
#: ``initialize`` brought up (the base port is generation 0's), for
#: :func:`reinitialize`; None when the caller brought the group up.
_GROUP_PARAMS: Optional[dict] = None
#: Gang generation of this process's clique (:func:`current_generation`);
#: None until first read.
_GENERATION: Optional[int] = None
#: Callables run, in registration order, after :func:`reinitialize` brought
#: a new process group up (``parallel/mesh.py`` rebuilds its subgroups).
_REINIT_HOOKS: list = []

#: Environment variable carrying the gang generation into a (re)launched
#: worker: the Supervisor stamps it on a replacement, so the new process
#: joins the reformed clique.
GENERATION_ENV = "TPU_DIST_GANG_GENERATION"
#: Environment variable naming the shared directory of the epoch-boundary
#: rejoin barrier; setting it arms ``RejoinGate`` in every fit.
REJOIN_DIR_ENV = "TPU_DIST_REJOIN_DIR"
#: Environment variable naming the shared directory of the mid-epoch gang
#: reform; setting it arms ``StepRejoinGate`` in every fit.
GANG_DIR_ENV = "TPU_DIST_GANG_DIR"
#: Seconds a teardown of the old process group may take before
#: :func:`reinitialize` gives up on it (gloo's takes milliseconds, even
#: with a dead peer).
TEARDOWN_TIMEOUT_S = 30.0


def local_device_index(config: ClusterConfig) -> int:
    """The CUDA device index of this task on its host: the number of tasks
    declared before it (in global process order) at the same host."""
    mine = config.task_address.rsplit(":", 1)[0]
    addrs = config.cluster.all_addresses()
    return sum(1 for a in addrs[:config.process_id]
               if a.rsplit(":", 1)[0] == mine)


def backend_for(communication: str, device: torch.device) -> str:
    """The ``torch.distributed`` backend of a ``CollectiveCommunication``
    mode (by name) for a process training on ``device``: RING is TF's
    collective implementation that does not use NCCL, here gloo (on CUDA
    tensors too); NCCL needs CUDA; AUTO is NCCL on CUDA, gloo on the CPU."""
    mode = communication.upper()
    if mode == "RING":
        return "gloo"
    if mode == "NCCL":
        if device.type != "cuda":
            raise ValueError(
                f"CollectiveCommunication.NCCL needs a CUDA device; this "
                f"process trains on {device} (use AUTO or RING for gloo)")
        return "nccl"
    if mode != "AUTO":
        raise ValueError(f"unknown CollectiveCommunication {communication!r}")
    return "nccl" if device.type == "cuda" else "gloo"


def _cuda_device(config: ClusterConfig,
                 backend: str = "nccl") -> torch.device:
    index = local_device_index(config)
    count = torch.cuda.device_count()
    if backend == "gloo":
        return torch.device("cuda", index % count)
    if index >= count:
        raise RuntimeError(
            f"task ({config.task.type}, {config.task.index}) is rank "
            f"{index + 1} on host {config.task_address.rsplit(':', 1)[0]}, "
            f"which has {count} CUDA device(s): NCCL cannot run two ranks on "
            f"one device. Declare at most one worker per card on each host, "
            f"or use the gloo backend (communication='ring', or "
            f"device='cpu')")
    return torch.device("cuda", index)


def initialize(config: ClusterConfig | None = None, *,
               device: DeviceLike = None,
               communication: str = "AUTO") -> torch.device:
    """Bring up the cluster runtime and return the device this process
    trains on. ``config`` defaults to ``TF_CONFIG``; ``device`` is the
    entry points' rule (CUDA unless ``"cpu"``); ``communication`` names a
    ``CollectiveCommunication`` mode, which chooses the backend. With more
    than one task a process group is created once (later calls return its
    device); with one task or none, nothing is brought up."""
    global _CONFIG, _DEVICE, _GROUP_PARAMS
    with _STATE_LOCK:
        if dist.is_available() and dist.is_initialized():
            want = resolve_device(device)
            if want.type != _DEVICE.type:
                raise ValueError(
                    f"the process group is up on {_DEVICE}; cannot train on "
                    f"{want} in the same process")
            return _DEVICE
        if config is None:
            config = ClusterConfig.from_env()
        dev = resolve_device(device)
        _CONFIG = config
        if config is None or config.num_processes < 2:
            logger.info("tpu_dist_torch: single-process local mode on %s",
                        dev)
            return dev
        backend = backend_for(communication, dev)
        if dev.type == "cuda":
            dev = _cuda_device(config, backend)
            torch.cuda.set_device(dev)
        logger.info(
            "tpu_dist_torch: initializing %d-process cluster from TF_CONFIG; "
            "task=(%s, %d) rank=%d chief=%s rendezvous=%s backend=%s "
            "device=%s", config.num_processes, config.task.type,
            config.task.index, config.process_id, config.is_chief,
            config.coordinator_address, backend, dev)
        # TF_CONFIG's address is generation 0's; a worker relaunched into
        # a reformed gang dials its generation's port (``reinitialize``).
        host, _, port = config.coordinator_address.rpartition(":")
        _GROUP_PARAMS = {"backend": backend, "host": host,
                         "base_port": int(port),
                         "world_size": config.num_processes,
                         "rank": config.process_id}
        dist.init_process_group(
            backend, init_method=f"tcp://{host}:"
            f"{int(port) + current_generation()}",
            world_size=config.num_processes, rank=config.process_id)
        _DEVICE = dev
        atexit.register(_shutdown)
        logger.info("tpu_dist_torch: cluster up — process %d/%d on %s",
                    dist.get_rank(), dist.get_world_size(), dev)
        return dev


def _shutdown() -> None:
    """Leave the process group at exit: the servers shut down when training
    ends. The liveness threads stop first: they use the group's store."""
    from tpu_dist_torch.cluster import liveness

    liveness.stop_shared()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def group_device() -> Optional[torch.device]:
    """The device this process trains on in its process group (None
    without a group)."""
    return _DEVICE if is_initialized() else None


def device_of_group() -> torch.device:
    """The device host data crosses in the process group's collectives:
    this process's card under NCCL, the CPU under gloo (and with no
    group)."""
    if is_initialized() and dist.get_backend() == "nccl":
        return _DEVICE
    return torch.device("cpu")


def is_initialized() -> bool:
    """True once a process group is up."""
    return dist.is_available() and dist.is_initialized()


def cluster_config() -> Optional[ClusterConfig]:
    """The parsed TF_CONFIG for this process, if any."""
    return _CONFIG


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_chief() -> bool:
    """Chief duty holder: explicit TF_CONFIG chief, else process 0."""
    if _CONFIG is not None:
        return _CONFIG.is_chief
    return process_index() == 0


def barrier(name: str = "tpu_dist_barrier") -> None:
    """Cluster-wide rendezvous (a no-op for one process): the reference's
    startup barrier. Fires the collectives' fault hook before and their
    observe hook after, with the seconds it waited (the cluster's skew)."""
    from tpu_dist_torch.parallel.collectives import (fire_fault_hook,
                                                     fire_observe_hook)

    fire_fault_hook("barrier")
    t0 = time.perf_counter()
    if process_count() > 1:
        logger.debug("tpu_dist_torch: barrier %s", name)
        dist.barrier()
    fire_observe_hook("barrier", seconds=time.perf_counter() - t0)


# -- gang generations ------------------------------------------------------------

def current_generation() -> int:
    """The gang generation of this process's clique: 0 at launch, bumped
    by every mid-epoch reform (:func:`reinitialize`); a worker relaunched
    into a reformed gang inherits it through ``$TPU_DIST_GANG_GENERATION``,
    so survivors and the replacement agree on it without talking."""
    global _GENERATION
    if _GENERATION is None:
        try:
            _GENERATION = int(os.environ.get(GENERATION_ENV, "0") or 0)
        except ValueError:
            _GENERATION = 0
    return _GENERATION


def on_reinitialize(hook: Callable[[], None]) -> None:
    """Run ``hook()`` after every :func:`reinitialize` that brought a new
    process group up (every process runs the hooks in the same order, so
    a hook may create groups)."""
    _REINIT_HOOKS.append(hook)


def _live_group_params() -> dict:
    """What the live default group was brought up with: ``initialize``'s
    record, else read from the group and its ``TCPStore`` (a group the
    caller brought up; its port is taken as this generation's)."""
    if _GROUP_PARAMS is not None:
        return dict(_GROUP_PARAMS)
    from torch.distributed import distributed_c10d

    store = distributed_c10d._get_default_store()
    while not hasattr(store, "port") and hasattr(store, "underlying_store"):
        store = store.underlying_store
    if not hasattr(store, "port"):
        raise RuntimeError(
            "reinitialize: the process group's store is not a TCPStore, so "
            "its address is unknown; bring the group up with a tcp:// "
            "init_method")
    return {"backend": dist.get_backend(), "host": store.host,
            "base_port": store.port - current_generation(),
            "world_size": dist.get_world_size(), "rank": dist.get_rank()}


def _bounded_destroy(timeout_s: float) -> float:
    """Destroy the default process group within ``timeout_s`` (raises
    past it: a new group cannot be brought up beside a live one);
    returns the seconds it took."""
    t0 = time.perf_counter()
    error: list = []

    def destroy():
        try:
            dist.destroy_process_group()
        except Exception as exc:  # noqa: BLE001 - re-raised below
            error.append(exc)

    worker = threading.Thread(target=destroy, daemon=True,
                              name="tpu_dist_torch_teardown")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise RuntimeError(
            f"reinitialize: tearing the old process group down took more "
            f"than {timeout_s:.0f}s; restart the gang")
    if error and dist.is_initialized():
        raise RuntimeError(
            f"reinitialize: the old process group could not be torn down: "
            f"{error[0]}") from error[0]
    return time.perf_counter() - t0


def reinitialize(generation: Optional[int] = None, *,
                 coordinator_port: Optional[int] = None) -> int:
    """Reform this process's clique under a new generation (``generation``
    when given, else the current one + 1) and return it.

    With no process group up (one process, or a file gang whose workers
    each run alone and meet only in the shared directory) there is nothing
    to tear down: the generation is re-stamped, which re-namespaces every
    later rendezvous marker, and ``$TPU_DIST_GANG_GENERATION`` with it.
    With a group up, the liveness threads stop, the group is destroyed
    (bounded by :data:`TEARDOWN_TIMEOUT_S`), and a new one is brought up
    with the same backend, world size and rank on ``host:(base port +
    generation)``, or on ``coordinator_port``: every survivor derives the
    same fresh port without talking, where the old one may have died with
    a lost rank 0 or sit in TIME_WAIT. The call blocks until every rank
    has joined. Then the :func:`on_reinitialize` hooks rebuild the mesh
    subgroups in place and the liveness monitor restarts, if it ran.
    ``last_reinit`` records the teardown and bring-up seconds."""
    global _GENERATION, _GROUP_PARAMS
    from tpu_dist_torch.cluster import liveness

    new_gen = (current_generation() + 1 if generation is None
               else int(generation))
    params = _live_group_params() if is_initialized() else None
    teardown_s = init_s = 0.0
    monitor_ran = False
    if params is not None:
        monitor_ran = liveness.stop_shared()
        teardown_s = _bounded_destroy(TEARDOWN_TIMEOUT_S)
    _GENERATION = new_gen
    os.environ[GENERATION_ENV] = str(new_gen)
    if params is None:
        logger.info("tpu_dist_torch: gang generation -> %d (no process "
                    "group; rendezvous namespace re-stamped)", new_gen)
        last_reinit.update(generation=new_gen, port=None, teardown_s=0.0,
                           init_s=0.0)
        return new_gen
    port = (int(coordinator_port) if coordinator_port is not None
            else params["base_port"] + new_gen)
    logger.info("tpu_dist_torch: reforming the %d-process group at "
                "generation %d (%s:%d, %s)", params["world_size"], new_gen,
                params["host"], port, params["backend"])
    t0 = time.perf_counter()
    dist.init_process_group(
        params["backend"], init_method=f"tcp://{params['host']}:{port}",
        world_size=params["world_size"], rank=params["rank"])
    init_s = time.perf_counter() - t0
    _GROUP_PARAMS = params
    for hook in _REINIT_HOOKS:
        hook()
    if monitor_ran:
        liveness.restart_shared()
    last_reinit.update(generation=new_gen, port=port, teardown_s=teardown_s,
                       init_s=init_s)
    return new_gen


#: The last :func:`reinitialize`: ``{generation, port, teardown_s,
#: init_s}`` (port None when no group was up).
last_reinit: dict = {}


# -- shared-directory barriers ---------------------------------------------------

def _default_rendezvous_namespace() -> str:
    """``g{generation}a{attempt}``: a marker of another generation or
    supervisor attempt can never satisfy this process's barrier."""
    from tpu_dist_torch.resilience.events import current_attempt

    return f"g{current_generation()}a{current_attempt()}"


def _reap_markers(d, rank: int, *, keep_namespace: str,
                  keep_min_epoch: Optional[int] = None) -> None:
    """Remove THIS rank's barrier markers that no barrier can wait on
    again: those of any other namespace (older generations or attempts,
    the legacy un-namespaced ones too) and, with ``keep_min_epoch``, those
    of the current namespace older than that epoch. Reform acks also end
    in ``rank-R``; they are the supervisor's and stay."""
    for old in d.glob(f"*rank-{rank}"):
        name = old.name
        if name.startswith("reform-"):
            continue
        if not name.startswith(keep_namespace + "."):
            _unlink(old)
            continue
        if keep_min_epoch is None:
            continue
        try:
            e = int(name.split(".")[1].split("-", 1)[1])
        except (IndexError, ValueError):
            continue
        if e < keep_min_epoch:
            _unlink(old)


def _unlink(path: pathlib.Path) -> None:
    try:
        path.unlink()
    except OSError:
        pass


def _fs_barrier(directory, *, marker_stem: str, rank: int, world: int,
                timeout_s: float, poll_s: float, what: str,
                gc_namespace: Optional[str] = None,
                gc_min_epoch: Optional[int] = None,
                abort_check=None) -> "list[int]":
    """Publish ``{marker_stem}.rank-{rank}`` atomically under
    ``directory`` and poll until all ``world`` ranks' markers of the stem
    exist; returns the sorted ranks. On timeout this rank's marker is
    reaped before the ``TimeoutError`` (which names the missing ranks), so
    a retry cannot count a process that gave up. ``abort_check()`` runs
    every round and may raise to break out (a reform seen while parked)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    marker = d / f"{marker_stem}.rank-{rank}"
    tmp = d / f".{marker_stem}.rank-{rank}.{os.getpid()}.tmp"
    tmp.write_text(str(os.getpid()), encoding="utf-8")
    os.replace(tmp, marker)
    if gc_namespace is not None:
        _reap_markers(d, rank, keep_namespace=gc_namespace,
                      keep_min_epoch=gc_min_epoch)
    deadline = time.monotonic() + timeout_s
    while True:
        if abort_check is not None:
            abort_check()
        present = set()
        for p in d.glob(f"{marker_stem}.rank-*"):
            suffix = p.name.rsplit("rank-", 1)[1]
            if suffix.isdigit():
                present.add(int(suffix))
        if len(present & set(range(world))) >= world:
            return sorted(present & set(range(world)))
        if time.monotonic() > deadline:
            missing = sorted(set(range(world)) - present)
            _unlink(marker)
            raise TimeoutError(
                f"{what} barrier in {d} timed out after {timeout_s:.1f}s; "
                f"missing rank(s) {missing} (present: {sorted(present)})")
        time.sleep(poll_s)


def epoch_rendezvous(directory, *, epoch: int, rank: Optional[int] = None,
                     world: Optional[int] = None, timeout_s: float = 120.0,
                     poll_s: float = 0.05,
                     namespace: Optional[str] = None) -> "list[int]":
    """The elastic rejoin's epoch-boundary barrier on a shared directory:
    ``{ns}.epoch-{E}.rank-{r}`` markers, ``ns`` by default
    ``g{generation}a{attempt}``. Not a collective: a relaunched worker is
    outside the survivors' group, and the barrier that lets it back in
    cannot need membership. Raises ``TimeoutError`` naming the missing
    ranks."""
    if rank is None:
        rank = process_index()
    if world is None:
        world = process_count()
    ns = namespace if namespace is not None else _default_rendezvous_namespace()
    return _fs_barrier(
        directory, marker_stem=f"{ns}.epoch-{epoch}", rank=rank, world=world,
        timeout_s=timeout_s, poll_s=poll_s,
        what=f"epoch_rendezvous: epoch {epoch} ({ns})",
        gc_namespace=ns, gc_min_epoch=epoch - 1)


def generation_rendezvous(directory, *, generation: int, step: int,
                          rank: Optional[int] = None,
                          world: Optional[int] = None,
                          timeout_s: float = 120.0, poll_s: float = 0.05,
                          abort_check=None) -> "list[int]":
    """The step-granular gang barrier of a reform, in the ``gen-{G}``
    namespace (``gen-{G}.step-{S}.rank-{r}``): a marker of the broken
    generation can never satisfy the reformed one's."""
    if rank is None:
        rank = process_index()
    if world is None:
        world = process_count()
    ns = f"gen-{generation}"
    return _fs_barrier(
        directory, marker_stem=f"{ns}.step-{step}", rank=rank, world=world,
        timeout_s=timeout_s, poll_s=poll_s,
        what=f"generation_rendezvous: generation {generation} step {step}",
        gc_namespace=ns, gc_min_epoch=None, abort_check=abort_check)


# -- the reform protocol's files (torn-read tolerant) ----------------------------
#
#   reform-request.json            supervisor -> survivors: rank R is lost;
#                                  drain, publish, reform at generation G
#   reform-g{G}.drained.rank-{r}   survivor -> supervisor: published; ack
#   reform-g{G}.restore            supervisor -> everyone: consensus step
#   generation                     supervisor -> everyone: committed G


def _atomic_write_json(path: pathlib.Path, payload: dict) -> None:
    import json

    tmp = path.parent / f".{path.name}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(payload), encoding="utf-8")
    os.replace(tmp, path)


def _read_json(path: pathlib.Path) -> Optional[dict]:
    import json

    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None


def request_reform(directory, *, generation: int, lost_ranks: "list[int]",
                   detect_s: Optional[float] = None) -> dict:
    """Publish a reform request (supervisor side), replacing any older
    one: at most one reform is in flight per gang directory."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    payload = {"generation": int(generation),
               "lost_ranks": sorted(int(r) for r in lost_ranks),
               "ts": time.time(), "detect_s": detect_s}
    _atomic_write_json(d / "reform-request.json", payload)
    return payload


def read_reform_request(directory) -> Optional[dict]:
    """The pending reform request, or None (missing, torn, malformed)."""
    req = _read_json(pathlib.Path(directory) / "reform-request.json")
    if not isinstance(req, dict) or "generation" not in req:
        return None
    return req


def withdraw_reform(directory) -> None:
    """Remove a pending request (an abandoned reform: a second loss or an
    ack timeout), so no relaunched worker drains into a reform nobody
    mediates. Idempotent."""
    _unlink(pathlib.Path(directory) / "reform-request.json")


def ack_reform(directory, *, generation: int, rank: int,
               available_step: Optional[int] = None) -> None:
    """A survivor's drained-and-published ack; ``available_step`` is its
    newest complete checkpoint step (the supervisor takes the minimum)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    _atomic_write_json(
        d / f"reform-g{int(generation)}.drained.rank-{int(rank)}",
        {"rank": int(rank), "available_step": available_step})


def read_reform_acks(directory, *, generation: int) -> "dict[int, dict]":
    """``{rank: ack}`` of the acks at ``generation`` (torn reads skip)."""
    acks: dict = {}
    for p in pathlib.Path(directory).glob(
            f"reform-g{int(generation)}.drained.rank-*"):
        suffix = p.name.rsplit("rank-", 1)[1]
        if not suffix.isdigit():
            continue
        payload = _read_json(p)
        if isinstance(payload, dict):
            acks[int(suffix)] = payload
    return acks


def publish_restore_step(directory, *, generation: int,
                         step: Optional[int]) -> None:
    """Commit the reform's consensus restore step (supervisor side); None:
    no checkpoint is common to the gang, every rank starts from scratch."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    _atomic_write_json(d / f"reform-g{int(generation)}.restore",
                       {"step": step})


def read_restore_step(directory, *,
                      generation: int) -> "tuple[bool, Optional[int]]":
    """``(published, step)`` of the reform's consensus restore step."""
    obj = _read_json(pathlib.Path(directory)
                     / f"reform-g{int(generation)}.restore")
    if not isinstance(obj, dict) or "step" not in obj:
        return (False, None)
    step = obj["step"]
    return (True, int(step) if step is not None else None)


def publish_generation(directory, generation: int) -> None:
    """Commit ``generation`` as the gang's current one (supervisor)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".generation.{os.getpid()}.tmp"
    tmp.write_text(str(int(generation)), encoding="utf-8")
    os.replace(tmp, d / "generation")


def read_generation(directory) -> int:
    """The committed gang generation of ``directory`` (0 when unset)."""
    try:
        return int((pathlib.Path(directory) / "generation")
                   .read_text(encoding="utf-8").strip())
    except (OSError, ValueError):
        return 0
