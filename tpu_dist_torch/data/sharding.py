"""Auto-shard policies as index transformations of the element stream.

Counterpart of ``tpu_dist/data/sharding.py`` for the port's in-memory
sources:

* OFF  — untouched: every worker iterates the full stream (the reference's
  choice: each worker draws its own shuffled batch, gradients are still
  all-reduced);
* DATA — each worker keeps every ``num_shards``-th element (applied before
  batching) or its contiguous ``1/num_shards`` slice of each batch
  (``pre_batched=True``, the distributed-dataset path);
* AUTO — FILE where the source has files, else DATA with a warning; the
  port's sources are in memory, so AUTO is DATA;
* HINT — treated as DATA;
* FILE — needs a file-backed source; the port has none yet, so it raises
  as the reference does for an in-memory source.
"""

from __future__ import annotations

import logging

import numpy as np

from tpu_dist_torch.data.pipeline import (AutoShardPolicy, Dataset,
                                          _map_structure)

logger = logging.getLogger("tpu_dist_torch.data")


def resolve_policy(dataset: Dataset, num_shards: int,
                   policy: AutoShardPolicy | None = None) -> AutoShardPolicy:
    """Collapse AUTO and HINT into the policy that will be applied."""
    if policy is None:
        policy = dataset.auto_shard_policy
    if policy == AutoShardPolicy.HINT:
        return AutoShardPolicy.DATA
    if policy == AutoShardPolicy.AUTO:
        if num_shards > 1:
            logger.warning(
                "AutoShardPolicy.AUTO: the source is not file-backed; "
                "falling back to DATA sharding over %d workers", num_shards)
        return AutoShardPolicy.DATA
    return policy


def shard_dataset(dataset: Dataset, num_shards: int, index: int,
                  policy: AutoShardPolicy | None = None, *,
                  pre_batched: bool = False) -> Dataset:
    """Apply an auto-shard policy for worker ``index`` of ``num_shards``.
    ``pre_batched=True`` means the elements are already global batches:
    DATA then slices each batch instead of striding elements."""
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} not in [0, {num_shards})")
    if num_shards == 1:
        return dataset
    concrete = resolve_policy(dataset, num_shards, policy)
    if concrete == AutoShardPolicy.OFF:
        return dataset
    if concrete == AutoShardPolicy.FILE:
        raise ValueError(
            "AutoShardPolicy.FILE requires a file-backed source; this "
            "pipeline roots in an in-memory source. Use DATA or OFF.")
    if pre_batched:
        return _slice_batches(dataset, num_shards, index)
    return dataset.shard(num_shards, index)


def _slice_batches(dataset: Dataset, num_shards: int, index: int) -> Dataset:
    """Worker ``index``'s contiguous slice of every batch. A batch that
    ``num_shards`` does not divide raises: unequal shards would make the
    mean of the per-worker means differ from the global batch's mean."""

    def _slice(a):
        a = np.asarray(a)
        b = a.shape[0]
        if b % num_shards:
            raise ValueError(
                f"global batch {b} not divisible by {num_shards} workers; "
                "make GLOBAL_BATCH_SIZE a multiple of the worker count")
        per = b // num_shards
        return a[index * per:(index + 1) * per]

    def factory():
        for batch in dataset:
            yield _map_structure(_slice, batch)

    return dataset._derive(factory)
