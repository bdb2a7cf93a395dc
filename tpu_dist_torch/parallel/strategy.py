"""Distribution-strategy front ends: the reference's user-facing API.

Counterpart of ``tpu_dist/parallel/strategy.py`` for one device per
process. In the JAX package a strategy is a factory for a named device
mesh; here it names the device its process trains on, how many processes
train in sync, and a mesh record of them (``parallel/mesh.py``):

* :class:`DefaultStrategy` — no distribution; the implicit strategy when
  none is scoped; the model trains where ``compile`` puts it;
* :class:`MirroredStrategy` — synchronous data parallelism over one host's
  devices; the port drives one device per process, so it is one replica
  (several devices in one process are ROADMAP item 12b);
* :class:`MultiWorkerMirroredStrategy` — the same across every process of
  the cluster: construction brings the cluster up (``bootstrap.initialize``
  from TF_CONFIG, on the backend its ``communication`` names) and waits at
  the startup barrier; the trainer then all-reduces every step's
  gradients. With one process and no cluster it behaves like
  MirroredStrategy.

``scope()`` pins the active strategy so that ``compile`` captures it
(:func:`get_strategy`), as in the reference program. The custom-loop
surface is the reference's: ``distribute_datasets_from_function`` with an
:class:`InputContext`, ``replicate``, ``distribute_batch``, ``run`` and
``reduce``. ``axis_shapes`` may name the data axis with a ``model`` axis
(tensor parallelism: ``compile`` keeps on each process the slice of each
parameter that ``parallel/tensor.py``'s rules name) and a ``seq`` axis
(ring attention: ``parallel/sequence.py``), a ``pipe`` axis (stages of a
``PipelinedBlocks``: ``parallel/pipeline_parallel.py``) and an ``expert``
axis (``parallel/expert.py``); the data-parallel replicas are the data
axis's processes, and the processes beside one on another axis read the
same batch. ``ParameterServerStrategy`` and the liveness monitor come
with later slices of the port.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.parallel import collectives
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel.axes import DATA_AXIS
from tpu_dist_torch.parallel.collectives import (CollectiveCommunication,
                                                 ReduceOp)
from tpu_dist_torch.utils.device import DeviceLike, resolve_device
from tpu_dist_torch.utils.errors import unported

logger = logging.getLogger("tpu_dist_torch.strategy")

_LOCAL = threading.local()


def _strategy_stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


class InputContext:
    """Per-process input-pipeline context handed to ``dataset_fn`` by
    :meth:`Strategy.distribute_datasets_from_function`, the analog of
    ``tf.distribute.InputContext``: which input pipeline this process is
    (``input_pipeline_id`` of ``num_input_pipelines``) and how to derive a
    per-replica batch from a global one."""

    def __init__(self, num_input_pipelines: int, input_pipeline_id: int,
                 num_replicas_in_sync: int):
        self.num_input_pipelines = num_input_pipelines
        self.input_pipeline_id = input_pipeline_id
        self.num_replicas_in_sync = num_replicas_in_sync

    def get_per_replica_batch_size(self, global_batch_size: int) -> int:
        if global_batch_size % self.num_replicas_in_sync:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{self.num_replicas_in_sync} replicas")
        return global_batch_size // self.num_replicas_in_sync

    def __repr__(self) -> str:
        return (f"InputContext(pipeline {self.input_pipeline_id}/"
                f"{self.num_input_pipelines}, "
                f"replicas={self.num_replicas_in_sync})")


def _check_axis_shapes(axis_shapes: Optional[dict]) -> None:
    """The reference's rule: the data axis must be there."""
    if axis_shapes is None:
        return
    if DATA_AXIS not in axis_shapes:
        raise ValueError(
            f"axis_shapes must include the {DATA_AXIS!r} axis (batches "
            f"shard over it), got {axis_shapes}")


def _as_tensor(leaf, device) -> torch.Tensor:
    """A result leaf of ``run`` as a detached tensor (a Python number in
    torch's default dtype, as ``jnp.asarray`` takes it in JAX's)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.asarray(leaf)).to(device)
    return torch.as_tensor(leaf, device=device)


class _Scope:
    def __init__(self, strategy: "Strategy"):
        self._strategy = strategy

    def __enter__(self):
        _strategy_stack().append(self._strategy)
        return self._strategy

    def __exit__(self, *exc):
        popped = _strategy_stack().pop()
        assert popped is self._strategy, "unbalanced strategy scopes"
        return False


class Strategy:
    """Base: the device this process trains on (``None`` lets ``compile``
    choose), the number of replicas training in sync, and their mesh."""

    #: The mesh is over this process alone (True) or every process.
    _local_mesh = True

    def __init__(self, device: Optional[torch.device] = None,
                 axis_shapes: Optional[dict] = None):
        self._device = device
        self._axis_shapes = axis_shapes
        self._mesh: Optional[mesh_lib.Mesh] = None
        if device is not None:  # the mesh checks axis_shapes
            self._mesh = self.mesh

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    @property
    def mesh(self) -> mesh_lib.Mesh:
        """The replicas' mesh: ``axis_shapes`` (default ``{'data': -1}``)
        over this strategy's processes, one device each."""
        if self._mesh is None:
            self._mesh = mesh_lib.make_mesh(
                self._axis_shapes, device=self._device,
                local=self._local_mesh or bootstrap.process_count() == 1)
        return self._mesh

    @property
    def data_axis(self) -> str:
        return DATA_AXIS

    @property
    def parallel_mesh(self) -> Optional[mesh_lib.Mesh]:
        """The mesh when an axis beside the data axis has size > 1 (tensor
        or sequence parallelism), else None."""
        if not self._axis_shapes or set(self._axis_shapes) <= {DATA_AXIS}:
            return None
        mesh = self.mesh
        return mesh if any(s > 1 for a, s in mesh.shape.items()
                           if a != DATA_AXIS) else None

    @property
    def data_group(self):
        """The group the replicas' reductions run over: the data axis's
        when the mesh has another parallel axis, else the whole process
        group (None)."""
        mesh = self.parallel_mesh
        return None if mesh is None else mesh_lib.axis_group(mesh,
                                                             DATA_AXIS)

    @property
    def num_replicas_in_sync(self) -> int:
        """Data-parallel replica count — TF's
        ``strategy.num_replicas_in_sync``."""
        return 1

    @property
    def is_chief(self) -> bool:
        return bootstrap.is_chief()

    def scope(self) -> _Scope:
        """Context manager pinning this strategy as current."""
        return _Scope(self)

    def experimental_distribute_dataset(self, dataset, policy=None):
        """Wrap a Dataset batched to the global batch size for per-process
        delivery under its auto-shard policy."""
        from tpu_dist_torch.data.distribute import DistributedDataset

        return DistributedDataset(dataset, self, policy=policy)

    def input_shard_info(self) -> tuple[int, int]:
        """``(num_input_shards, shard_id)`` for the host input pipeline:
        one pipeline per data-parallel replica, the process's coordinate on
        the data axis (the processes beside it on a model or sequence axis
        read the same shard)."""
        if self.num_replicas_in_sync == 1:
            return 1, 0
        return (self.num_replicas_in_sync,
                mesh_lib.coordinate(self.mesh, DATA_AXIS))

    def replicate(self, tree, *, broadcast: Optional[bool] = None):
        """A tree of arrays or tensors as new tensors on this process's
        device; in a process group, process 0's values (the mirrored
        variables' initial broadcast) unless ``broadcast=False``."""
        if broadcast is None:
            broadcast = bootstrap.process_count() > 1
        return mesh_lib.replicate(tree, self.mesh, broadcast=broadcast)

    def distribute_batch(self, batch):
        """This process's batch (a tree of host arrays, as a distributed
        dataset yields it) as tensors on its device: the process's part of
        the global batch, which the JAX package assembles into one sharded
        array."""
        return mesh_lib.place_batch(batch, self.mesh.device)

    def distribute_datasets_from_function(self, dataset_fn, options=None):
        """Per-worker dataset construction, TF's
        ``strategy.distribute_datasets_from_function``:
        ``dataset_fn(InputContext)`` builds this process's stream, batched
        to the per-replica size (``ctx.get_per_replica_batch_size(
        global)``). Pipelines follow the processes, one replica each, so
        each step takes one element of the stream and the global batch is
        ``per_replica_batch x num_replicas_in_sync``. The fn already did
        any cross-worker sharding (it knows its ``input_pipeline_id``), so
        the result is a ``DistributedDataset`` under
        ``AutoShardPolicy.OFF``; it yields host batches
        (:meth:`distribute_batch` puts one on the device)."""
        from tpu_dist_torch.data.distribute import DistributedDataset
        from tpu_dist_torch.data.pipeline import AutoShardPolicy

        num_pipelines, pipeline_id = self.input_shard_info()
        ctx = InputContext(num_input_pipelines=num_pipelines,
                           input_pipeline_id=pipeline_id,
                           num_replicas_in_sync=self.num_replicas_in_sync)
        return DistributedDataset(dataset_fn(ctx), self,
                                  policy=AutoShardPolicy.OFF)

    experimental_distribute_datasets_from_function = \
        distribute_datasets_from_function

    def run(self, fn, args=(), kwargs=None):
        """Run ``fn`` on this process's replica, TF's ``strategy.run``:
        ``fn(*args, **kwargs)`` sees the arguments as they are (a batch from
        :meth:`distribute_batch` is this replica's rows). Every leaf of the
        result (tensors, or numbers made tensors on this device) comes back
        detached and stacked on a leading replica axis
        ``[num_replicas_in_sync, ...]`` through ``collectives.all_gather``,
        identical on every process, so ``strategy.reduce("mean",
        run(...))`` is the global mean, as in the reference.

        Gradients differ from the reference. There, ``run`` is one SPMD
        program, and differentiating with respect to a replicated argument
        sums the cotangents across the replicas. Here ``fn`` runs eagerly
        on one replica, and a gradient taken inside it is this replica's
        alone: a custom loop means its gradients across the replicas
        explicitly, with ``collectives.all_reduce(grads, "mean")``."""
        out = fn(*args, **(kwargs or {}))
        device = self.mesh.device
        return collectives.all_gather(
            collectives.tree_map(lambda t: _as_tensor(t, device), out),
            group=self.data_group)

    def reduce(self, op: ReduceOp | str, value):
        """Reduction of per-replica values (a leading replica axis) to one
        result, leaf by leaf over tuples, lists and dicts, as TF's
        ``strategy.reduce``; a scalar passes through."""
        op = ReduceOp(op) if not isinstance(op, ReduceOp) else op
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise ValueError(f"host-side reduce supports SUM/MEAN, got {op}")

        def red(leaf):
            if isinstance(leaf, dict):
                return {k: red(v) for k, v in leaf.items()}
            if isinstance(leaf, (tuple, list)):
                return type(leaf)(red(v) for v in leaf)
            v = leaf if torch.is_tensor(leaf) else np.asarray(leaf)
            if not v.ndim:
                return v
            if op is ReduceOp.SUM:
                return v.sum(0) if torch.is_tensor(v) else v.sum(axis=0)
            if not torch.is_tensor(v):
                return v.mean(axis=0)
            # The mean of integers is a float, as in jnp.
            return (v if v.is_floating_point()
                    else v.to(torch.get_default_dtype())).mean(0)

        return red(value)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(replicas={self.num_replicas_in_sync},"
                f" device={self._device})")


class DefaultStrategy(Strategy):
    """No distribution: one device, the implicit strategy when none is
    scoped."""


class MirroredStrategy(Strategy):
    """Synchronous data parallelism over one host's devices. The port
    drives one device per process: ``devices`` may name at most one (more
    is ROADMAP item 12b), and the strategy is one replica on ``device``
    (CUDA unless ``"cpu"``)."""

    def __init__(self, devices: Sequence | None = None,
                 axis_shapes: Optional[dict] = None, *,
                 device: DeviceLike = None):
        _check_axis_shapes(axis_shapes)
        if devices is not None:
            devices = list(devices)
            if len(devices) > 1:
                raise unported("MirroredStrategy over several devices in "
                               "one process", "12b")
            device = devices[0] if devices else device
        super().__init__(resolve_device(device), axis_shapes)
        logger.info("MirroredStrategy: 1 replica on %s", self._device)


class MultiWorkerMirroredStrategy(Strategy):
    """Synchronous data parallelism across all cluster processes, one
    replica each. Construction brings the cluster up where the reference
    does (``bootstrap.initialize``: TF_CONFIG -> process group, blocking
    until every process has joined) on the backend ``communication``
    names (AUTO: NCCL on CUDA, gloo on the CPU; RING: gloo, on CUDA
    tensors too, which lets several workers share one card; NCCL), then
    passes the startup barrier. With one process and no cluster it is one
    local replica."""

    def __init__(self,
                 communication: CollectiveCommunication | str | None = None,
                 cluster_config=None, axis_shapes: Optional[dict] = None, *,
                 device: DeviceLike = None):
        _check_axis_shapes(axis_shapes)
        self.communication = CollectiveCommunication.resolve(communication)
        super().__init__(
            bootstrap.initialize(cluster_config, device=device,
                                 communication=self.communication.name),
            axis_shapes)
        bootstrap.barrier("MultiWorkerMirroredStrategy_init")
        # Peer-health checks start after the startup barrier, so they
        # cannot fire during bring-up (the reference's order); one pair of
        # threads a process, none for one process.
        from tpu_dist_torch.cluster.liveness import shared_monitor

        self.liveness_monitor = shared_monitor().start()
        cfg = bootstrap.cluster_config()
        logger.info(
            "MultiWorkerMirroredStrategy up: num_workers = %d, "
            "num_replicas_in_sync = %d, communication = %s, device = %s, "
            "cluster_spec = %s", bootstrap.process_count(),
            self.num_replicas_in_sync, self.communication.name, self._device,
            dict(cfg.cluster.jobs) if cfg else "<local>")

    _local_mesh = False

    @property
    def num_replicas_in_sync(self) -> int:
        """The data axis's size: the processes on a model or sequence axis
        are one replica."""
        return self.mesh.shape[DATA_AXIS]


_default_strategy: Optional[DefaultStrategy] = None


def get_strategy() -> Strategy:
    """Innermost scoped strategy, or the (cached) DefaultStrategy."""
    stack = _strategy_stack()
    if stack:
        return stack[-1]
    global _default_strategy
    if _default_strategy is None:
        _default_strategy = DefaultStrategy()
    return _default_strategy


def has_strategy() -> bool:
    return bool(_strategy_stack())
