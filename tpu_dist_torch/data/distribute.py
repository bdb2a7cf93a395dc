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
  keeps its ``1/num_processes`` slice of every batch.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.data.pipeline import (AutoShardPolicy, Dataset,
                                          _map_structure)
from tpu_dist_torch.data.sharding import resolve_policy, shard_dataset

logger = logging.getLogger("tpu_dist_torch.data")


class DistributedDataset:
    """Iterable of this process's batches for a strategy —
    ``strategy.experimental_distribute_dataset(dataset)``; ``fit`` wraps a
    plain Dataset the same way."""

    def __init__(self, dataset: Dataset, strategy,
                 policy: AutoShardPolicy | None = None):
        self._strategy = strategy
        self._num_processes = bootstrap.process_count()
        self._process_index = bootstrap.process_index()
        effective = (policy if policy is not None
                     else dataset.auto_shard_policy)
        if effective == AutoShardPolicy.OFF:
            self._policy = AutoShardPolicy.OFF
            self._local = dataset
        else:
            self._policy = resolve_policy(dataset, self._num_processes,
                                          effective)
            self._local = shard_dataset(dataset, self._num_processes,
                                        self._process_index, self._policy,
                                        pre_batched=True)
        if self._num_processes > 1:
            logger.info("DistributedDataset: policy=%s process=%d/%d",
                        self._policy.name, self._process_index,
                        self._num_processes)

    def cardinality(self) -> int | None:
        """Batches per pass of this process's stream, if known."""
        return self._local.cardinality()

    def __iter__(self) -> Iterator:
        for batch in self._local:
            batch = _map_structure(np.asarray, batch)
            leaves: list = []
            _map_structure(leaves.append, batch)
            leading = {a.shape[0] for a in leaves}
            if len(leading) != 1:
                raise ValueError(
                    f"batch components disagree on batch dim: {leading}")
            yield batch
