"""Host-side input pipeline: a tf.data-shaped ``Dataset`` of numpy elements.

Counterpart of ``tpu_dist/data/pipeline.py``, the subset the reference
program runs: ``from_tensor_slices``, ``map``, ``cache``, ``shuffle``,
``batch``, ``repeat``, ``take``, ``shard``, ``with_options`` and
``cardinality``, with ``Options`` carrying
``experimental_distribute.auto_shard_policy`` and TF's ``AutoShardPolicy``
values. A copy kept in the port (numpy only): the same source, seed and
combinators give the reference's elements in the reference's order — a
seeded ``shuffle`` draws from ``np.random.default_rng(seed + epoch)``
exactly as the reference does, and an unseeded one draws a fresh order per
pass and per process (the reference's OFF-policy mode relies on that).
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np


class AutoShardPolicy(enum.IntEnum):
    """TF ``tf.data.experimental.AutoShardPolicy`` values; the reference
    sets OFF."""

    OFF = -1
    AUTO = 0
    FILE = 1
    DATA = 2
    HINT = 3


class _DistributeOptions:
    """Mirror of ``options.experimental_distribute``'s attribute shape."""

    def __init__(self) -> None:
        self.auto_shard_policy = AutoShardPolicy.AUTO

    def __repr__(self) -> str:
        return (f"_DistributeOptions(auto_shard_policy="
                f"{self.auto_shard_policy!r})")


class Options:
    """Dataset options — the auto-shard policy the reference sets."""

    def __init__(self) -> None:
        self.experimental_distribute = _DistributeOptions()

    def __repr__(self) -> str:
        return f"Options({self.experimental_distribute!r})"


def _map_structure(fn, element):
    if isinstance(element, tuple):
        return tuple(_map_structure(fn, e) for e in element)
    if isinstance(element, dict):
        return {k: _map_structure(fn, v) for k, v in element.items()}
    return fn(element)


def _batch_structure(elements: Sequence) -> Any:
    """Stack identically structured elements into batched arrays."""
    first = elements[0]
    if isinstance(first, tuple):
        return tuple(_batch_structure([e[i] for e in elements])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _batch_structure([e[k] for e in elements]) for k in first}
    return np.stack([np.asarray(e) for e in elements])


class Dataset:
    """A lazily evaluated element pipeline, built from a factory that returns
    a fresh iterator per pass: iterating twice replays the source (and
    redraws an unseeded shuffle), as tf.data re-iteration does."""

    def __init__(self, it_factory: Callable[[], Iterator], *,
                 options: Options | None = None,
                 cardinality: int | None = None):
        self._it_factory = it_factory
        self._options = options or Options()
        self._cardinality = cardinality

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_tensor_slices(tensors) -> "Dataset":
        """Elements are slices along the leading axis."""
        arrays = _map_structure(np.asarray, tensors)
        leaves: list = []
        _map_structure(leaves.append, arrays)
        if not leaves:
            raise ValueError("from_tensor_slices requires at least one array")
        n = len(leaves[0])
        for leaf in leaves:
            if len(leaf) != n:
                raise ValueError(f"all arrays must share the leading dim, "
                                 f"got {len(leaf)} != {n}")

        def factory():
            for i in range(n):
                yield _map_structure(lambda a: a[i], arrays)

        return Dataset(factory, cardinality=n)

    # -- combinators (each returns a new Dataset) -------------------------------

    def map(self, fn: Callable) -> "Dataset":
        def factory():
            for el in self._it_factory():
                yield fn(*el) if isinstance(el, tuple) else fn(el)

        return self._derive(factory)

    def cache(self) -> "Dataset":
        """Materialize on the first complete pass; later passes replay it. A
        partial or concurrent pass re-reads the source instead."""
        store: list = []
        complete = threading.Event()
        lock = threading.Lock()

        def factory():
            if complete.is_set():
                yield from store
                return
            local: list = []
            for el in self._it_factory():
                local.append(el)
                yield el
            with lock:
                if not complete.is_set():
                    store.extend(local)
                    complete.set()

        return self._derive(factory)

    def shuffle(self, buffer_size: int, seed: int | None = None,
                reshuffle_each_iteration: bool = True) -> "Dataset":
        """Buffer-based shuffle with tf.data semantics: fill a buffer of
        ``buffer_size``, emit a random occupant, refill. Unseeded, each pass
        (and each process) draws an independent order."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if seed is None and not reshuffle_each_iteration:
            # tf.data: an unseeded non-reshuffling dataset picks one seed at
            # construction and replays that order every pass.
            seed = int(np.random.default_rng().integers(2**31))
        epoch_counter = itertools.count()

        def factory():
            it = self._it_factory()
            epoch = next(epoch_counter)
            if seed is None:
                rng = np.random.default_rng()
            else:
                rng = np.random.default_rng(
                    seed + (epoch if reshuffle_each_iteration else 0))
            buf = list(itertools.islice(it, buffer_size))
            for el in it:
                idx = rng.integers(len(buf))
                out, buf[idx] = buf[idx], el
                yield out
            rng.shuffle(buf)
            yield from buf

        return self._derive(factory)

    def batch(self, batch_size: int,
              drop_remainder: bool = False) -> "Dataset":
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")

        def factory():
            acc = []
            for el in self._it_factory():
                acc.append(el)
                if len(acc) == batch_size:
                    yield _batch_structure(acc)
                    acc = []
            if acc and not drop_remainder:
                yield _batch_structure(acc)

        card = None
        if self._cardinality is not None:
            card = (self._cardinality // batch_size if drop_remainder
                    else -(-self._cardinality // batch_size))
        return self._derive(factory, cardinality=card)

    def repeat(self, count: int | None = None) -> "Dataset":
        def factory():
            n = 0
            while count is None or n < count:
                empty = True
                for el in self._it_factory():
                    empty = False
                    yield el
                if empty:
                    return
                n += 1

        card = None
        if count is not None and self._cardinality is not None:
            card = count * self._cardinality
        return self._derive(factory, cardinality=card)

    def take(self, count: int) -> "Dataset":
        def factory():
            yield from itertools.islice(self._it_factory(), count)

        card = (None if self._cardinality is None
                else min(count, self._cardinality))
        return self._derive(factory, cardinality=card)

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Every ``num_shards``-th element starting at ``index``."""
        if not 0 <= index < num_shards:
            raise ValueError(f"index {index} not in [0, {num_shards})")

        def factory():
            yield from itertools.islice(self._it_factory(), index, None,
                                        num_shards)

        card = None
        if self._cardinality is not None:
            card = (self._cardinality - index + num_shards - 1) // num_shards
        return self._derive(factory, cardinality=card)

    def with_options(self, options: Options) -> "Dataset":
        """Attach options — the auto-shard-policy carrier."""
        ds = self._derive(self._it_factory)
        ds._options = options
        return ds

    # -- introspection ------------------------------------------------------------

    @property
    def auto_shard_policy(self) -> AutoShardPolicy:
        return self._options.experimental_distribute.auto_shard_policy

    def cardinality(self) -> int | None:
        """Element count if statically known, else None."""
        return self._cardinality

    def __iter__(self) -> Iterator:
        return self._it_factory()

    def _derive(self, factory, cardinality: int | None | str = "inherit"
                ) -> "Dataset":
        return Dataset(factory, options=self._options,
                       cardinality=(self._cardinality
                                    if cardinality == "inherit"
                                    else cardinality))
