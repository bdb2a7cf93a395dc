"""Auto-shard policies as transformations of the element stream.

Counterpart of ``tpu_dist/data/sharding.py``:

* OFF  — untouched: every worker iterates the full stream (the reference's
  choice: each worker draws its own shuffled batch, gradients are still
  all-reduced);
* DATA — each worker keeps every ``num_shards``-th element (applied before
  batching) or its contiguous ``1/num_shards`` slice of each batch
  (``pre_batched=True``, the distributed-dataset path);
* FILE — re-root the combinator chain on a strided subset of the source's
  files (worker i reads files i, i+n, ...), rebatching the final global
  batch to the per-worker size on the pre-batched path. FILE over too few
  files, over a non-file source or over files that do not divide evenly
  raises;
* AUTO — FILE when the source is file-backed and its files divide evenly
  over the workers, else DATA with a warning;
* HINT — treated as DATA.
"""

from __future__ import annotations

import logging

import numpy as np

from tpu_dist_torch.data.pipeline import (AutoShardPolicy, Dataset,
                                          _map_structure)

logger = logging.getLogger("tpu_dist_torch.data")


def _file_root(dataset: Dataset) -> Dataset | None:
    """The chain's file-backed source, if the chain roots in one and every
    link records its transform (so the chain can be replayed on it)."""
    d = dataset
    while d._parent is not None:
        if d._transform is None:
            return None
        d = d._parent
    return d if d._file_shard_fn is not None else None


def _is_file_shardable(dataset: Dataset, num_shards: int) -> bool:
    """FILE applies iff the chain is replayable on a file-backed source
    with at least ``num_shards`` files."""
    return (_file_root(dataset) is not None
            and dataset.num_files >= num_shards)


def _files_divide_evenly(dataset: Dataset, num_shards: int) -> bool:
    """Synchronous training needs every worker's stream equally long: the
    file count must divide evenly and, where the source knows its per-file
    counts, every worker's strided subset must sum to the same total.
    Called only on a chain that roots in a file-backed source."""
    if dataset.num_files % num_shards != 0:
        return False
    counts = _file_root(dataset)._file_cardinalities
    if counts:
        totals = {sum(counts[i::num_shards]) for i in range(num_shards)}
        return len(totals) == 1
    return True


def resolve_policy(dataset: Dataset, num_shards: int,
                   policy: AutoShardPolicy | None = None) -> AutoShardPolicy:
    """Collapse AUTO and HINT into the policy that will be applied."""
    if policy is None:
        policy = dataset.auto_shard_policy
    if policy == AutoShardPolicy.HINT:
        return AutoShardPolicy.DATA
    if policy == AutoShardPolicy.AUTO:
        if num_shards <= 1:
            return AutoShardPolicy.DATA
        if (_is_file_shardable(dataset, num_shards)
                and _files_divide_evenly(dataset, num_shards)):
            return AutoShardPolicy.FILE
        logger.warning(
            "AutoShardPolicy.AUTO: source has %d file(s) for %d workers "
            "(not file-backed, too few, or not evenly divisible); falling "
            "back to DATA sharding", dataset.num_files, num_shards)
        return AutoShardPolicy.DATA
    return policy


def shard_dataset(dataset: Dataset, num_shards: int, index: int,
                  policy: AutoShardPolicy | None = None, *,
                  pre_batched: bool = False) -> Dataset:
    """Apply an auto-shard policy for worker ``index`` of ``num_shards``.
    ``pre_batched=True`` means the elements are already global batches:
    DATA then slices each batch instead of striding elements, and FILE
    rebatches the last ``batch(GLOBAL)`` to ``GLOBAL / num_shards``."""
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} not in [0, {num_shards})")
    if num_shards == 1:
        return dataset
    concrete = resolve_policy(dataset, num_shards, policy)
    if concrete == AutoShardPolicy.OFF:
        return dataset
    if concrete == AutoShardPolicy.FILE:
        if _file_root(dataset) is None:
            raise ValueError(
                "AutoShardPolicy.FILE requires a file-backed source "
                "(Dataset.from_files / sources.load over sharded files); "
                "this pipeline roots in an in-memory source. Use DATA or OFF.")
        if dataset.num_files < num_shards:
            raise ValueError(
                f"AutoShardPolicy.FILE requires >= {num_shards} source files, "
                f"dataset has {dataset.num_files}. Use DATA or OFF.")
        if not _files_divide_evenly(dataset, num_shards):
            raise ValueError(
                f"AutoShardPolicy.FILE: {dataset.num_files} files do not "
                f"divide evenly over {num_shards} workers (by file count or "
                "by per-file element totals); synchronous training requires "
                "equal-length worker streams. Re-shard the source "
                "(sources.write_sharded) to a multiple of the worker count "
                "with balanced shards, or use DATA.")
        return _file_shard(dataset, num_shards, index, rebatch=pre_batched)
    if pre_batched:
        return _slice_batches(dataset, num_shards, index)
    return dataset.shard(num_shards, index)


def _file_shard(dataset: Dataset, num_shards: int, index: int, *,
                rebatch: bool) -> Dataset:
    """Re-root the chain on worker ``index``'s strided file subset and
    replay its transforms. ``rebatch=True`` also rewrites the last
    ``batch(GLOBAL)`` into ``batch(GLOBAL / num_shards)``: the user batched
    to the global size, but each worker now holds only its files."""
    transforms: list[tuple[str, dict]] = []
    d = dataset
    while d._parent is not None:
        transforms.append(d._transform)
        d = d._parent
    transforms.reverse()
    if rebatch:
        for i in range(len(transforms) - 1, -1, -1):
            name, kw = transforms[i]
            if name == "batch":
                b = kw["batch_size"]
                if b % num_shards:
                    raise ValueError(
                        f"global batch {b} not divisible by {num_shards} "
                        "workers; make GLOBAL_BATCH_SIZE a multiple of the "
                        "worker count")
                transforms[i] = ("batch", {**kw,
                                           "batch_size": b // num_shards})
                break
    out = d._file_shard_fn(num_shards, index)
    for t in transforms:
        out = out._replay_transform(t)
    return out


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
