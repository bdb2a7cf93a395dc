"""Distribution-strategy front ends: the reference's user-facing API.

Counterpart of ``tpu_dist/parallel/strategy.py`` for one device per
process. In the JAX package a strategy is a factory for a named device
mesh; here it names the device its process trains on and how many
processes train in sync:

* :class:`DefaultStrategy` — no distribution; the implicit strategy when
  none is scoped; the model trains where ``compile`` puts it;
* :class:`MirroredStrategy` — synchronous data parallelism over one host's
  devices; the port drives one device per process, so it is one replica;
* :class:`MultiWorkerMirroredStrategy` — the same across every process of
  the cluster: construction brings the cluster up (``bootstrap.initialize``
  from TF_CONFIG) and waits at the startup barrier; the trainer then
  all-reduces every step's gradients. With one process and no cluster it
  behaves like MirroredStrategy.

``scope()`` pins the active strategy so that ``compile`` captures it
(:func:`get_strategy`), as in the reference program. ``run``,
``distribute_datasets_from_function``, ``axis_shapes`` (extra mesh axes)
and the liveness monitor come with later slices of the port and raise.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_dist_torch.cluster import bootstrap
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
    choose) and the number of replicas training in sync."""

    def __init__(self, device: Optional[torch.device] = None):
        self._device = device

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

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

    def distribute_datasets_from_function(self, dataset_fn, options=None):
        raise unported("strategy.distribute_datasets_from_function", 12)

    experimental_distribute_datasets_from_function = \
        distribute_datasets_from_function

    def run(self, fn, args=(), kwargs=None):
        raise unported("strategy.run", 12)

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
            return v.mean(0) if torch.is_tensor(v) else v.mean(axis=0)

        return red(value)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(replicas={self.num_replicas_in_sync},"
                f" device={self._device})")


class DefaultStrategy(Strategy):
    """No distribution: one device, the implicit strategy when none is
    scoped."""


class MirroredStrategy(Strategy):
    """Synchronous data parallelism over one host's devices. The port
    drives one device per process: ``devices`` may name at most one, and
    the strategy is one replica on ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, devices: Sequence | None = None,
                 axis_shapes: Optional[dict] = None, *,
                 device: DeviceLike = None):
        if axis_shapes is not None:
            raise unported("MirroredStrategy(axis_shapes=)", 12)
        if devices is not None:
            devices = list(devices)
            if len(devices) > 1:
                raise unported("MirroredStrategy over several devices in "
                               "one process", 12)
            device = devices[0] if devices else device
        super().__init__(resolve_device(device))
        logger.info("MirroredStrategy: 1 replica on %s", self._device)


class MultiWorkerMirroredStrategy(Strategy):
    """Synchronous data parallelism across all cluster processes, one
    replica each. Construction brings the cluster up where the reference
    does (``bootstrap.initialize``: TF_CONFIG -> process group, blocking
    until every process has joined), then passes the startup barrier. With
    one process and no cluster it is one local replica."""

    def __init__(self,
                 communication: CollectiveCommunication | str | None = None,
                 cluster_config=None, axis_shapes: Optional[dict] = None, *,
                 device: DeviceLike = None):
        if axis_shapes is not None:
            raise unported("MultiWorkerMirroredStrategy(axis_shapes=)", 12)
        self.communication = CollectiveCommunication.resolve(communication)
        super().__init__(bootstrap.initialize(cluster_config, device=device))
        bootstrap.barrier("MultiWorkerMirroredStrategy_init")
        cfg = bootstrap.cluster_config()
        logger.info(
            "MultiWorkerMirroredStrategy up: num_workers = %d, "
            "num_replicas_in_sync = %d, communication = %s, device = %s, "
            "cluster_spec = %s", bootstrap.process_count(),
            self.num_replicas_in_sync, self.communication.name, self._device,
            dict(cfg.cluster.jobs) if cfg else "<local>")

    @property
    def num_replicas_in_sync(self) -> int:
        return bootstrap.process_count()


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
