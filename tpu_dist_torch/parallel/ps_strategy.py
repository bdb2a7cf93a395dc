"""ParameterServerStrategy: asynchronous bounded-staleness training.

Counterpart of ``tpu_dist/parallel/ps_strategy.py``: a second execution
model beside the gang-synchronous stack.

* The **server** (:class:`PSServer`) owns the authoritative parameters and
  the optimizer state (the model's own trainer's, so ``Adam(fused=True)``
  applies through ``csrc/fused_adam.cu`` on the card and ``SGD(fused=True)``
  through ``csrc/fused_sgd.cu``); it discovers pushed gradient packets,
  applies them in arrival order (recording that order in the apply log),
  publishes versioned parameter snapshots, checkpoints asynchronously and
  checksums its leaves every apply-epoch
  (:func:`~tpu_dist_torch.training.integrity.host_leaf_checksums`).
* **Workers** run a collective-free loop (``Trainer._fit_ps``): pull the
  parameters, one local forward and backward, push the gradients. They
  never meet each other, so a lost worker is a non-event.

The transport is the file protocol of
:mod:`tpu_dist_torch.cluster.ps_transport`, on disk the reference's byte
for byte: the npz keys are the ``jax.tree_util.keystr`` paths of the
parameter tree (``models/bridge.flatten_keys``), so a reference server
applies this package's pushes and this package's server the reference's.

**Bounded staleness** (``TPU_DIST_PS_STALENESS``, default
:data:`~tpu_dist_torch.cluster.ps_transport.DEFAULT_STALENESS`) is enforced
at pull time: a worker with more than S of its own pushes unapplied waits
for the server. ``TPU_DIST_PS_SYNC=1`` makes the server gang-synchronous
(one packet from every live rank a round, in rank order), the control the
straggler gate compares against.

What an asynchronous run guarantees is not bit parity with a synchronous
twin but reproducibility given its apply log: every apply records (rank,
seq, base version), and :func:`replay_apply_log` re-applies the retained
packets in logged order to the same final checksums, bit for bit on the
same device.

Differences from the JAX package: a tree here is nested dicts, lists and
NamedTuples of tensors or arrays (a model's parameters nest by their
dotted names, :func:`params_tree`); the server's starting parameters are
``model.init(seed)`` as in the reference, or with ``seed=None`` the
model's own (weights bridged from the reference, say); and the step key
(:func:`worker_step_key`) is a ``torch.Generator``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from tpu_dist_torch.cluster import ps_transport
from tpu_dist_torch.cluster.ps_transport import PS_DIR_ENV, PSDir
from tpu_dist_torch.models import bridge
from tpu_dist_torch.parallel.strategy import Strategy
from tpu_dist_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("tpu_dist_torch.parallel.ps")

#: Per-rank stream spacing: worker r's local step k folds
#: ``(r + 1) * _RANK_STRIDE + k`` into the root seed, the reference's fold.
_RANK_STRIDE = 10_000_019
_SEED_MOD = 2 ** 63


def _to_host(leaves: list) -> list:
    """Host numpy copies of ``leaves``: the tensors of one device and dtype
    cross in one copy (a per-leaf ``.cpu()`` waits on the card once a
    leaf, each wait a turn among the processes sharing it)."""
    out: list = [None] * len(leaves)
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            groups.setdefault((leaf.device, leaf.dtype), []).append(i)
        elif isinstance(leaf, torch.Tensor):
            out[i] = leaf.detach().numpy()
        else:
            out[i] = np.asarray(leaf)
    for idx in groups.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        parts = np.split(flat.cpu().numpy(), np.cumsum(
            [leaves[i].numel() for i in idx])[:-1])
        for i, part in zip(idx, parts):
            out[i] = part.reshape(tuple(leaves[i].shape))
    return out


def _to_device(arrays: list, device: torch.device) -> list:
    """``arrays`` (host, one dtype) as tensors on ``device`` through one
    copy, split into views."""
    flat = np.concatenate([np.ravel(a) for a in arrays])
    moved = torch.from_numpy(flat).to(device)
    return [t.view(a.shape) for t, a in zip(
        moved.split([int(np.size(a)) for a in arrays]), arrays)]


def named_tree(pairs) -> dict:
    """``(dotted name, leaf)`` pairs as the reference's tree: nested dicts
    by the names' parts (``conv2d.kernel`` -> ``{'conv2d': {'kernel':
    leaf}}``)."""
    tree: dict = {}
    for name, leaf in pairs:
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def params_tree(model) -> dict:
    """The model's live parameters as the reference's params tree."""
    return named_tree(model.named_parameters())


def tree_to_arrays(tree: Any) -> dict:
    """Flatten a tree to ``{keystr path: host ndarray}``, the npz namespace
    that publishes, pushes and replays share."""
    flat = bridge.flatten_keys(tree)
    return dict(zip(flat, _to_host(list(flat.values()))))


def arrays_to_tree(template: Any, arrays: dict) -> Any:
    """``template``'s structure with the arrays of :func:`tree_to_arrays`
    output as its leaves (each checked against the template leaf's
    shape)."""

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(node[k], f"{path}[{k!r}]") for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f), f"{path}.{f}")
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub, f"{path}[{i}]")
                              for i, sub in enumerate(node))
        if path not in arrays:
            raise KeyError(f"PS snapshot missing array {path!r}")
        arr = arrays[path]
        want = tuple(node.shape) if hasattr(node, "shape") else np.shape(node)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"PS snapshot array {path!r} has shape "
                             f"{arr.shape}, expected {tuple(want)}")
        return arr

    return build(template, "")


def load_params(model, tree) -> None:
    """Copy a params tree of host arrays (a pull's) into the model's
    parameters in place."""
    arrays = bridge.flatten_keys(tree)
    named = list(model.named_parameters())
    values = _to_device(
        [np.asarray(arrays[bridge.keypath(n)]) for n, _ in named],
        named[0][1].device)
    with torch.no_grad():
        for (_, p), v in zip(named, values):
            p.copy_(v)


def worker_step_key(root_key: int, *, rank: int, local_step: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Generator:
    """The generator for worker ``rank``'s ``local_step``, seeded from the
    reference's fold ``(rank + 1) * 10_000_019 + local_step`` of
    ``root_key`` alone (``generator`` is reseeded in place, else a new CPU
    one is made). A pure function of coordinates, which makes an apply-log
    replay exact. Its bits cannot equal JAX's ``fold_in``; the demo CNN
    and the LM draw no randomness in a step, so their packets do not
    depend on it."""
    seed = (int(root_key) * 1_000_003
            + (int(rank) + 1) * _RANK_STRIDE + int(local_step)) % _SEED_MOD
    gen = generator if generator is not None else torch.Generator()
    return gen.manual_seed(seed)


class ParameterServerStrategy(Strategy):
    """Asynchronous parameter-server training over the file transport.

    The role comes from ``role=`` or ``TPU_DIST_PS_ROLE``: a ``"worker"``
    scopes a collective-free one-device strategy whose ``fit`` runs pull,
    local step, push (``training/trainer.py``); a ``"server"`` process runs
    :class:`PSServer`. Both share one
    :class:`~tpu_dist_torch.cluster.ps_transport.PSDir` session directory
    (``ps_dir=`` or ``TPU_DIST_PS_DIR``). ``device`` is the process's
    device (CUDA unless ``"cpu"``)."""

    def __init__(self, ps_dir: Optional[str] = None, *,
                 role: Optional[str] = None, rank: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 staleness: Optional[int] = None,
                 sync: Optional[bool] = None,
                 pull_timeout_s: Optional[float] = None,
                 device: DeviceLike = None):
        ps_dir = ps_dir or os.environ.get(PS_DIR_ENV)
        if not ps_dir:
            raise ValueError(
                "ParameterServerStrategy needs a session directory: pass "
                f"ps_dir= or set ${PS_DIR_ENV}")
        # One device, one replica: nothing in a worker's step can reduce
        # across workers, even by accident.
        super().__init__(resolve_device(device))
        self.psdir = PSDir(ps_dir).ensure()
        self.role = role or ps_transport.role_from_env() or "worker"
        if self.role not in ("server", "worker"):
            raise ValueError(f"PS role must be server/worker, got "
                             f"{self.role!r}")
        self.rank = ps_transport.rank_from_env() if rank is None else int(rank)
        self.num_workers = (ps_transport.world_from_env()
                            if num_workers is None else int(num_workers))
        self.staleness = (ps_transport.staleness_from_env()
                          if staleness is None else max(0, int(staleness)))
        self.sync = ps_transport.sync_from_env() if sync is None else bool(sync)
        if self.sync:
            # Every round waits for every rank: a worker running ahead of
            # its own applies would deadlock the round. Lock-step.
            self.staleness = 0
        self.pull_timeout_s = (ps_transport.pull_timeout_from_env()
                               if pull_timeout_s is None
                               else float(pull_timeout_s))
        self._pushed = 0
        self._last_version: Optional[int] = None
        logger.info("ParameterServerStrategy: role=%s rank=%d world=%d "
                    "staleness=%d sync=%s dir=%s device=%s", self.role,
                    self.rank, self.num_workers, self.staleness, self.sync,
                    ps_dir, self._device)

    @property
    def is_worker(self) -> bool:
        return self.role == "worker"

    @property
    def is_server(self) -> bool:
        return self.role == "server"

    @property
    def pushed(self) -> int:
        """Gradient packets this worker has pushed so far."""
        return self._pushed

    # -- worker transport -----------------------------------------------------

    def pull(self, params_template: Any) -> Optional[tuple]:
        """Blocking bounded-staleness pull: ``(params, version)``, the
        freshest published parameters as ``params_template``'s tree of
        host arrays, or None once the server ordered STOP.

        Waits while more than ``staleness`` of this worker's pushes are
        unapplied, and checks the snapshot against the manifest's leaf
        checksums (a torn or flipped snapshot never trains)."""
        from tpu_dist_torch.observe import metrics
        from tpu_dist_torch.training import integrity

        t0 = time.perf_counter()
        deadline = t0 + self.pull_timeout_s
        rank_key = str(self.rank)
        while True:
            # The manifest first: the snapshot is read only once the window
            # allows (the reference reads it every poll).
            manifest = self.psdir.read_manifest()
            if manifest is not None and (
                    self._pushed - int(manifest.get("applied", {})
                                       .get(rank_key, 0)) <= self.staleness):
                loaded = self.psdir.load_published()
                if loaded is not None:
                    manifest, arrays = loaded
                    pending = self._pushed - int(
                        manifest.get("applied", {}).get(rank_key, 0))
                    if pending <= self.staleness:
                        break
            if self.psdir.stop_requested() is not None:
                return None
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"PS pull timed out after {self.pull_timeout_s:.0f}s "
                    f"(rank {self.rank}: {self._pushed} pushed, server "
                    "silent) — is the server process alive?")
            time.sleep(0.002)
        integrity.verify_pull_checksums(arrays, manifest)
        metrics.observe_value("ps.staleness", float(pending))
        metrics.observe_value("ps.pull_s", time.perf_counter() - t0)
        metrics.inc("ps.pulls")
        self._last_version = int(manifest["version"])
        return arrays_to_tree(params_template, arrays), self._last_version

    def push(self, grads: Any, *, loss: float) -> int:
        """Publish one gradient packet (a tree keyed as the parameters);
        returns this worker's push seq."""
        from tpu_dist_torch.observe import metrics

        t0 = time.perf_counter()
        seq = self._pushed
        self.psdir.push_grad(
            tree_to_arrays(grads), rank=self.rank, seq=seq,
            meta={"base_version": self._last_version,
                  "loss": float(loss), "time": time.time()})
        self._pushed += 1
        metrics.observe_value("ps.push_s", time.perf_counter() - t0)
        metrics.inc("ps.pushes")
        return seq

    def heartbeat(self, *, step: int) -> None:
        self.psdir.heartbeat(self.rank, step=step)

    def mark_done(self, *, steps: int) -> None:
        self.psdir.mark_done(self.rank, steps=steps)


def _start_from(model, seed: Optional[int]) -> None:
    """The server's and the replay's starting parameters: ``model.init
    (seed)`` (the reference's), or the model's own with ``seed=None``."""
    if seed is None:
        return
    fresh = bridge.flatten_keys(model.init(seed)["params"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(fresh[bridge.keypath(name)])


def _grads_on(params: list, names: list, arrays: dict) -> list:
    return _to_device([arrays[bridge.keypath(n)] for n in names],
                      params[0].device)


class PSServer:
    """The server: authoritative parameters and optimizer state,
    arrival-order applies, versioned publishes, asynchronous checkpoints,
    apply-epoch checksums. One thread (the checkpointer's writer is the
    only other, and touches no PS state): discover, apply, log, publish,
    so the apply order is the log order.

    ``model`` is a compiled model whose optimizer applies the packets
    (through its trainer's optimizer state, which its checkpoints hold);
    its parameters start from ``model.init(seed)``, or as they are with
    ``seed=None``."""

    def __init__(self, model, psdir: PSDir, *, num_workers: int,
                 budget: int, seed: Optional[int] = 0, sync: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 publish_every: int = 1, ckpt_every: int = 8,
                 checksum_every: Optional[int] = None,
                 dead_after_s: float = 20.0,
                 retain_grads: bool = False,
                 idle_timeout_s: float = 300.0):
        self.model = model
        self.psdir = psdir.ensure()
        self.num_workers = int(num_workers)
        self.budget = int(budget)
        self.sync = bool(sync)
        self.checkpoint_dir = checkpoint_dir
        self.publish_every = max(1, int(publish_every))
        self.ckpt_every = max(1, int(ckpt_every))
        # One virtual gang step's applies, by default.
        self.checksum_every = max(1, int(checksum_every or num_workers))
        self.dead_after_s = float(dead_after_s)
        self.retain_grads = bool(retain_grads)
        self.idle_timeout_s = float(idle_timeout_s)

        _start_from(model, seed)
        self.trainer = model._get_trainer("loss optimizer")
        self.trainer.variables = None  # fresh optimizer state
        self.trainer.ensure_variables(0 if seed is None else seed)
        self._names = [n for n, _ in model.named_parameters()]
        self._params = list(self.trainer.variables["params"])
        self.applies = 0
        self.applied_by_rank: dict = {r: 0 for r in range(self.num_workers)}
        self._seen: set = set()
        self._ckpt_covered = 0  # applies covered by a published checkpoint
        self._ckpt = None
        self._t_first_apply: Optional[float] = None
        self._t_last_apply: Optional[float] = None
        #: Seconds of each apply (H2D copy and the optimizer's update).
        self.apply_s: list = []
        self.restored_from: Optional[int] = None
        self._faults = self._arm_faults()

    # -- fault seam (the chaos runner addresses the server by apply index) ---

    @staticmethod
    def _arm_faults():
        from tpu_dist_torch.resilience import events
        from tpu_dist_torch.resilience.faults import FAULT_PLAN_ENV, FaultPlan

        spec = os.environ.get(FAULT_PLAN_ENV)
        if not spec:
            return []
        rank = ps_transport.rank_from_env()
        plan = FaultPlan.parse(spec)
        return [f for f in plan.for_process(rank, events.current_attempt())
                if f.kind == "kill"]

    def _check_faults(self) -> None:
        from tpu_dist_torch.resilience import events

        for f in self._faults:
            if f.due_at_step(self.applies):
                events.maybe_log("fault_fired", kind="kill",
                                 at=f"server apply {self.applies}",
                                 exit_code=f.exit_code)
                logger.warning("fault injection: killing PS server at "
                               "apply %d (exit %d)", self.applies,
                               f.exit_code)
                os._exit(f.exit_code)

    # -- restore --------------------------------------------------------------

    def maybe_restore(self) -> None:
        """Server restart: restore the parameters and optimizer state from
        the newest complete checkpoint in place, rewind the apply log to it
        and check the restored leaves against the log's checksum epoch at
        that step (storage corruption between checkpoint and restart
        aborts). Packets applied after the restored step are still in
        ``grads/`` (their deletion lags checkpoint coverage), so the loop
        re-applies them."""
        if not self.checkpoint_dir:
            return
        from tpu_dist_torch.resilience import events
        from tpu_dist_torch.training import checkpoint as ckpt_lib
        from tpu_dist_torch.training import integrity

        step = ckpt_lib.latest_complete_step(self.checkpoint_dir)
        if step is None:
            return
        step = ckpt_lib.restore_model(self.checkpoint_dir, self.model,
                                      step=step, trainer=self.trainer)
        self.applies = self._ckpt_covered = step
        self.restored_from = step
        kept = []
        for r in self.psdir.read_apply_log():
            if r.get("event") == "checksum_epoch":
                if int(r.get("applies", 0)) <= step:
                    kept.append(r)
            elif "rank" in r and int(r.get("apply", 0)) <= step:
                kept.append(r)
        self.psdir.rewrite_apply_log(kept)
        for rec in kept:
            if "rank" in rec:
                self.applied_by_rank[int(rec["rank"])] = (
                    self.applied_by_rank.get(int(rec["rank"]), 0) + 1)
                name = f"g-r{int(rec['rank'])}-{int(rec['seq']):08d}.npz"
                self._seen.add(name)
                if not self.retain_grads:
                    try:
                        (self.psdir.grads / name).unlink()
                    except OSError:
                        pass
        epochs = [r for r in kept if r.get("event") == "checksum_epoch"
                  and int(r.get("applies", -1)) == step]
        if epochs:
            live = integrity.host_leaf_checksums(
                tree_to_arrays(params_tree(self.model)))
            logged = {k: int(v) for k, v in epochs[-1]["checksums"].items()}
            if live != logged:
                raise integrity.IntegrityAbort(
                    f"PS server restore: restored params at apply {step} do "
                    "not match the apply log's checksum epoch — storage "
                    "corruption between checkpoint and restart")
        events.maybe_log("ps_server_restore", step=step)
        logger.info("PS server restored apply %d from %s", step,
                    self.checkpoint_dir)

    # -- publish / checkpoint -------------------------------------------------

    def _snapshot(self) -> tuple:
        """The parameters' host arrays and their checksums."""
        from tpu_dist_torch.training import integrity

        arrays = tree_to_arrays(params_tree(self.model))
        return arrays, integrity.host_leaf_checksums(arrays)

    def _publish(self, snapshot: Optional[tuple] = None) -> None:
        from tpu_dist_torch.observe import metrics

        arrays, sums = snapshot or self._snapshot()
        self.psdir.publish_params(
            arrays, version=self.applies, applied=self.applied_by_rank,
            checksums=sums)
        metrics.set_gauge("ps.version", float(self.applies))

    def _checksum_epoch(self, sums: dict) -> None:
        from tpu_dist_torch.observe import metrics
        from tpu_dist_torch.resilience import events

        self.psdir.append_apply_log({
            "event": "checksum_epoch",
            "applies": self.applies,
            "epoch": self.applies // self.checksum_every,
            "checksums": sums,
        })
        events.maybe_log("ps_checksum_epoch", applies=self.applies,
                         n_leaves=len(sums))
        metrics.inc("ps.checksum_epochs")

    def _gc_grads(self) -> None:
        """Delete packets only once a published checkpoint covers their
        apply: a server killed mid-interval must find every uncovered
        packet on disk to re-apply."""
        if self.retain_grads:
            return
        for rec in self.psdir.read_apply_log():
            if "rank" in rec and rec.get("apply", 0) <= self._ckpt_covered:
                try:
                    (self.psdir.grads /
                     f"g-r{int(rec['rank'])}-{int(rec['seq']):08d}.npz"
                     ).unlink()
                except OSError:
                    pass

    # -- liveness -------------------------------------------------------------

    def _live_ranks(self) -> list:
        done = self.psdir.done_ranks()
        live = []
        for r in range(self.num_workers):
            if r in done:
                continue
            age = self.psdir.heartbeat_age_s(r)
            if age is not None and age > self.dead_after_s:
                continue  # silent too long: dead, a non-event
            live.append(r)
        return live

    # -- the loop -------------------------------------------------------------

    def _apply_packet(self, path) -> bool:
        from tpu_dist_torch.observe import metrics

        loaded = PSDir.load_grad(path)
        self._seen.add(path.name)
        if loaded is None:
            return False  # raced a GC unlink; never a torn file
        meta, arrays = loaded
        t0 = time.perf_counter()
        grads = _grads_on(self._params, self._names, arrays)
        with torch.no_grad():
            self.model.optimizer.update(grads, self.trainer.variables["opt"],
                                        self._params)
        if self._params[0].device.type == "cuda":
            torch.cuda.current_stream(self._params[0].device).synchronize()
        self.apply_s.append(time.perf_counter() - t0)
        self.applies += 1
        now = time.perf_counter()
        if self._t_first_apply is None:
            self._t_first_apply = now
        self._t_last_apply = now
        rank = int(meta["rank"])
        self.applied_by_rank[rank] = self.applied_by_rank.get(rank, 0) + 1
        lag = max(0.0, time.time() - float(meta.get("time", time.time())))
        metrics.observe_value("ps.apply_lag", lag)
        metrics.inc("ps.applies")
        # The replay contract: coordinates only, never wall-clock.
        self.psdir.append_apply_log({
            "apply": self.applies, "rank": rank, "seq": int(meta["seq"]),
            "base_version": meta.get("base_version"),
            "loss": meta.get("loss"),
        })
        due_sums = self.applies % self.checksum_every == 0
        due_publish = self.applies % self.publish_every == 0
        snapshot = self._snapshot() if due_sums or due_publish else None
        if due_sums:
            self._checksum_epoch(snapshot[1])
        if due_publish:
            self._publish(snapshot)
        if self.checkpoint_dir and self.applies % self.ckpt_every == 0:
            self._save_async()
        return True

    def _save_async(self) -> None:
        if self._ckpt is not None:
            self._ckpt.save_async(self.model, step=self.applies)

    def run(self) -> dict:
        """Serve until the apply budget is reached (STOP is then ordered)
        or every worker is done or dead with no packet pending. Returns the
        session's stats, which the chaos runner gates on."""
        from tpu_dist_torch.resilience import events
        from tpu_dist_torch.training import checkpoint as ckpt_lib

        self._ckpt = (ckpt_lib.AsyncCheckpointer(self.checkpoint_dir)
                      if self.checkpoint_dir else None)
        self.maybe_restore()
        # Version 0 (or the restored version): the rendezvous, workers
        # wait in pull until it lands.
        self._publish()
        events.maybe_log("ps_server_start", applies=self.applies,
                         budget=self.budget, sync=self.sync,
                         restored_from=self.restored_from)
        t0 = time.perf_counter()
        last_progress = t0
        stop_reason = None
        while True:
            self._check_faults()
            if self.applies >= self.budget:
                stop_reason = "budget"
                break
            pending = self.psdir.scan_grads(seen=self._seen)
            if self.sync:
                progressed = self._sync_round(pending)
            else:
                progressed = False
                for path in pending:
                    if self._apply_packet(path):
                        progressed = True
                    self._check_faults()
                    if self.applies >= self.budget:
                        break
            now = time.perf_counter()
            if progressed:
                last_progress = now
                # Coverage comes from the directory: a save handed to the
                # writer is not durable until latest_complete_step sees it.
                if self._ckpt is not None:
                    done_step = ckpt_lib.latest_complete_step(
                        self.checkpoint_dir)
                    if done_step is not None:
                        self._ckpt_covered = max(self._ckpt_covered,
                                                 done_step)
                    self._gc_grads()
                continue
            if not self._live_ranks():
                if not self.psdir.scan_grads(seen=self._seen):
                    stop_reason = "workers_done"
                    break
            if now - last_progress > self.idle_timeout_s:
                stop_reason = "idle_timeout"
                break
            time.sleep(0.002)
        wall_s = time.perf_counter() - t0
        self.psdir.write_stop(reason=stop_reason, applies=self.applies)
        self._publish()
        if self._ckpt is not None:
            self._ckpt.save_async(self.model, step=self.applies)
            self._ckpt.close()
            self._ckpt_covered = self.applies
            self._gc_grads()
        # Throughput over the apply span (first to last apply), the gated
        # number: the wall also holds the workers' start-up.
        span_s = ((self._t_last_apply or 0.0) - (self._t_first_apply or 0.0))
        throughput = (round((self.applies - 1) / span_s, 6)
                      if span_s > 0 and self.applies > 1 else None)
        events.maybe_log("ps_server_stop", reason=stop_reason,
                         applies=self.applies, wall_s=round(wall_s, 6),
                         throughput_sps=throughput)
        return {
            "applies": self.applies,
            "wall_s": round(wall_s, 6),
            "apply_span_s": round(span_s, 6),
            "throughput_sps": throughput,
            "stop_reason": stop_reason,
            "applied_by_rank": {str(r): n for r, n in
                                sorted(self.applied_by_rank.items())},
            "restored_from": self.restored_from,
            "sync": self.sync,
        }

    def _sync_round(self, pending: list) -> bool:
        """Gang-synchronous control: one packet from every live rank, in
        rank order; the round goes at the slowest rank's pace."""
        by_rank: dict = {}
        for path in pending:
            r = int(path.name.split("-")[1][1:])
            by_rank.setdefault(r, []).append(path)
        live = self._live_ranks()
        if not live:
            return False
        if not all(r in by_rank for r in live):
            return False  # the round is incomplete: wait for stragglers
        for r in live:
            self._apply_packet(by_rank[r][0])
        return True


def replay_apply_log(psdir: PSDir, model, *, seed: Optional[int] = 0) -> dict:
    """Re-apply the session's retained packets in logged order from the
    server's start (``model.init(seed)``, or the model's own parameters
    with ``seed=None``) with a fresh optimizer state; returns ``{"applies",
    "checksums"}``. Same packets, same order, same optimizer on the same
    device: the same parameters, bit for bit. Needs ``retain_grads=True``
    on the recording server."""
    from tpu_dist_torch.training import integrity

    _start_from(model, seed)
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    optimizer = model.optimizer
    opt = optimizer.init(params)
    applies = 0
    for rec in psdir.read_apply_log():
        if "rank" not in rec:
            continue
        path = (psdir.grads /
                f"g-r{int(rec['rank'])}-{int(rec['seq']):08d}.npz")
        loaded = PSDir.load_grad(path)
        if loaded is None:
            raise FileNotFoundError(
                f"replay needs retained packet {path.name}; record with "
                "retain_grads=True")
        _, arrays = loaded
        with torch.no_grad():
            optimizer.update(_grads_on(params, names, arrays), opt, params)
        applies += 1
    return {
        "applies": applies,
        "checksums": integrity.host_leaf_checksums(
            tree_to_arrays(params_tree(model))),
    }
