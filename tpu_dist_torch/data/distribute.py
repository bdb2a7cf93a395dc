"""Distributed dataset delivery: each process's share of the global batches.

Counterpart of ``tpu_dist/data/distribute.py``. The JAX package assembles
every process's local batch into one global array sharded over the mesh;
in the port each process is one replica that trains on its local batch and
all-reduces its gradients, so a :class:`DistributedDataset` yields this
process's numpy batches and the trainer moves them to its device. The two
delivery modes are the reference's:

* ``with_options(OFF)``: every worker iterates the full stream (with its
  own unseeded shuffle, a different order per worker); the effective
  global batch is ``local batch x workers`` samples;
* AUTO / DATA: the user batches to the global batch size and each process
  keeps its ``1/num_processes`` slice of every batch;
* FILE (or AUTO over a file-backed source whose files divide evenly): each
  process reads its strided subset of the files, and the chain's last
  ``batch(GLOBAL)`` becomes ``batch(GLOBAL / num_processes)``.

As in the reference, the local stream is first offered to the vectorized
chain rewrite (``data/vectorize.py``) and then prefetched on a host
thread unless the chain already prefetches.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.data import vectorize
from tpu_dist_torch.data.pipeline import (AutoShardPolicy, Dataset,
                                          _map_structure)
from tpu_dist_torch.data.sharding import resolve_policy, shard_dataset

logger = logging.getLogger("tpu_dist_torch.data")


def _find_unseeded_shuffle(dataset) -> bool:
    """True if the recorded chain holds a shuffle whose order differs per
    process: ``seed=None`` (a fresh rng per pass), or a seed drawn at
    construction in each process (``auto_seeded``)."""
    node = dataset
    while node is not None:
        t = getattr(node, "_transform", None)
        if (t is not None and t[0] == "shuffle"
                and (t[1].get("seed") is None or t[1].get("auto_seeded"))):
            return True
        node = getattr(node, "_parent", None)
    return False


def check_replicated_determinism(dataset, num_shards: int,
                                 num_processes: int, path: str) -> None:
    """Guard for a layout whose data shards are fewer than its processes:
    processes that share a shard must produce identical batches. A chain
    with an unseeded shuffle certainly does not, and raises; any other
    pipeline cannot be proven either way and gets a warning. The port's
    strategies give every process a shard of its own on a data-only mesh,
    so their datasets pass it by construction; a mesh whose data axis spans
    fewer processes (a model or sequence axis beside it) calls it."""
    if num_shards >= num_processes:
        return
    if _find_unseeded_shuffle(dataset):
        raise ValueError(
            f"{path}: unseeded shuffle while {num_processes} processes share "
            f"{num_shards} data shard(s) — processes on the same shard would "
            "draw different samples for the same global batch region and "
            "training would silently diverge. Pass shuffle(..., seed=...) so "
            "they produce identical streams.")
    logger.warning(
        "%s with %d processes on %d data shard(s): processes on the same "
        "shard MUST yield identical batches (deterministic pipeline, seeded "
        "or no shuffle) or training silently diverges", path, num_processes,
        num_shards)


class DistributedDataset:
    """Iterable of this process's batches for a strategy —
    ``strategy.experimental_distribute_dataset(dataset)``; ``fit`` wraps a
    plain Dataset the same way.

    ``prefetch`` (default 2; None or 0: none) produces that many batches
    ahead on a host thread. ``allow_device_transform`` lets the rewrite
    ship uint8 images with their scale as a :attr:`device_transform`: the
    trainer applies it on its device (``device``, default the strategy's),
    but a caller iterating this object in a loop of its own gets the
    host-scaled float32 batches."""

    def __init__(self, dataset: Dataset, strategy,
                 policy: AutoShardPolicy | None = None,
                 prefetch: int | None = 2,
                 allow_device_transform: bool = False, device=None):
        self._strategy = strategy
        self._num_processes = bootstrap.process_count()
        self._process_index = bootstrap.process_index()
        # One shard per data-parallel replica: the processes beside it on a
        # model or sequence axis read its shard too.
        shards, index = self._num_processes, self._process_index
        if strategy is not None and strategy.parallel_mesh is not None:
            shards, index = strategy.input_shard_info()
        effective = (policy if policy is not None
                     else dataset.auto_shard_policy)
        if effective == AutoShardPolicy.OFF:
            self._policy = AutoShardPolicy.OFF
            self._local = dataset
        else:
            check_replicated_determinism(dataset, shards,
                                         self._num_processes,
                                         "DistributedDataset")
            self._policy = resolve_policy(dataset, shards, effective)
            self._local = shard_dataset(dataset, shards, index, self._policy,
                                        pre_batched=True)
        if device is None and strategy is not None:
            device = strategy.device
        fast = vectorize.try_rewrite(
            self._local,
            defer_scale_to_device=None if allow_device_transform else False,
            device=device)
        if fast is not None:
            self._local = fast
        if prefetch and not self._local._prefetched:
            self._local = self._local.prefetch(prefetch)
        if self._num_processes > 1:
            logger.info("DistributedDataset: policy=%s process=%d/%d",
                        self._policy.name, self._process_index,
                        self._num_processes)

    @property
    def auto_shard_policy(self) -> AutoShardPolicy:
        return self._policy

    @property
    def device_transform(self):
        """The function the trainer applies to the x batch on its device
        (None for a plain pipeline): the device half of the uint8-on-the-
        wire normalization."""
        return self._local._device_transform

    def cardinality(self) -> int | None:
        """Batches per pass of this process's stream, if known."""
        return self._local.cardinality()

    def iter_local(self) -> Iterator:
        """This process's host batches (numpy), each checked for one batch
        dimension across its components."""
        for batch in self._local:
            batch = _map_structure(np.asarray, batch)
            leaves: list = []
            _map_structure(leaves.append, batch)
            leading = {a.shape[0] for a in leaves}
            if len(leading) != 1:
                raise ValueError(
                    f"batch components disagree on batch dim: {leading}")
            yield batch

    def __iter__(self) -> Iterator:
        return self.iter_local()
