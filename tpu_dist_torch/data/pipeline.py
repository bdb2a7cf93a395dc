"""Host-side input pipeline: a tf.data-shaped ``Dataset`` of numpy elements.

Counterpart of ``tpu_dist/data/pipeline.py``: the constructors
``from_tensor_slices``, ``from_generator``, ``from_files`` and ``range``;
the combinators ``map``, ``filter``, ``cache``, ``shuffle``, ``batch``,
``repeat``, ``take``, ``skip``, ``shard``, ``interleave``, ``unbatch``,
``concatenate``, ``zip``, ``prefetch`` and ``with_options``; ``Options``
carrying ``experimental_distribute.auto_shard_policy`` with TF's
``AutoShardPolicy`` values; and :class:`DevicePrefetcher`. A copy kept in
the port (numpy only): the same source, seed and combinators give the
reference's elements in the reference's order — a seeded ``shuffle``
draws from ``np.random.default_rng(seed + epoch)`` exactly as the
reference does, and an unseeded one draws a fresh order per pass and per
process (the reference's OFF-policy mode relies on that).

Every derived dataset records its parent and a ``(name, kwargs)``
transform, and a ``from_tensor_slices`` source keeps its arrays: that
record is what ``data/vectorize.py`` parses to run a chain as index math
and batched gathers, or to promote it to a device-resident
``DeviceDataset``.
"""

from __future__ import annotations

import enum
import itertools
import queue as queue_lib
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence

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


def _call(fn: Callable, el):
    """``fn`` on an element: a tuple spreads over the arguments."""
    return fn(*el) if isinstance(el, tuple) else fn(el)


#: Transforms after which a dataset keeps its parent's device transform:
#: the ones that change the stream's shape, never an element's value.
_KEEPS_DEVICE_TRANSFORM = frozenset(
    ("prefetch", "with_options", "repeat", "take", "skip", "shard", "batch"))


class Dataset:
    """A lazily evaluated element pipeline, built from a factory that returns
    a fresh iterator per pass: iterating twice replays the source (and
    redraws an unseeded shuffle), as tf.data re-iteration does."""

    def __init__(self, it_factory: Callable[[], Iterator], *,
                 options: Options | None = None,
                 cardinality: int | None = None,
                 num_files: int = 1):
        self._it_factory = it_factory
        self._options = options or Options()
        self._cardinality = cardinality
        #: Set by prefetch() anywhere upstream: DistributedDataset then
        #: adds no prefetch of its own.
        self._prefetched = False
        #: Source-file count (the shard policies' FILE/AUTO decision).
        self.num_files = num_files
        # The chain's record: each derived dataset's parent and its
        # (name, kwargs) transform (None: opaque to the rewrite).
        self._parent: "Dataset | None" = None
        self._transform: tuple[str, dict] | None = None
        #: The source arrays of a from_tensor_slices dataset.
        self._tensor_source = None
        #: A from_files source's per-file counts and its
        #: ``(num_shards, index) -> Dataset`` strided-subset constructor.
        self._file_cardinalities: list[int] | None = None
        self._file_shard_fn: Callable[[int, int], "Dataset"] | None = None
        #: A function the trainer applies to the x batch on its device
        #: (data/vectorize.py): a uint8 batch crosses to the card and is
        #: scaled there.
        self._device_transform: Callable | None = None

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

        ds = Dataset(factory, cardinality=n)
        ds._tensor_source = arrays
        return ds

    @staticmethod
    def from_generator(gen_factory: Callable[[], Iterable]) -> "Dataset":
        """Elements of ``gen_factory()``, called anew on every pass."""
        return Dataset(lambda: iter(gen_factory()))

    @staticmethod
    def from_files(files: Sequence, reader: Callable[[Any], Iterable], *,
                   cardinality: int | None = None,
                   file_cardinalities: Sequence[int] | None = None
                   ) -> "Dataset":
        """A file-backed source: ``reader(file)``'s elements, file by file,
        in the given order — the source AutoShardPolicy.FILE strides across
        workers. ``file_cardinalities`` (per-file element counts, when
        known) lets a worker's strided subset keep a known cardinality."""
        files = list(files)
        if not files:
            raise ValueError("from_files requires at least one file")
        if file_cardinalities is not None:
            file_cardinalities = list(file_cardinalities)
            if len(file_cardinalities) != len(files):
                raise ValueError(
                    f"file_cardinalities has {len(file_cardinalities)} "
                    f"entries for {len(files)} files")
            total = sum(file_cardinalities)
            if cardinality is None:
                cardinality = total
            elif cardinality != total:
                raise ValueError(
                    f"cardinality {cardinality} != sum(file_cardinalities) "
                    f"{total}")

        def factory():
            for f in files:
                yield from reader(f)

        ds = Dataset(factory, cardinality=cardinality, num_files=len(files))
        #: Per-file counts: the FILE guard checks that every worker's
        #: strided subset carries the same element total.
        ds._file_cardinalities = file_cardinalities
        # Worker i of n reads files i, i+n, ...; the subset keeps its own
        # file count and (with per-file counts) its own cardinality.
        ds._file_shard_fn = lambda n, i: Dataset.from_files(
            files[i::n], reader,
            file_cardinalities=(None if file_cardinalities is None
                                else file_cardinalities[i::n]))
        return ds

    @staticmethod
    def range(n: int) -> "Dataset":
        return Dataset(lambda: iter(range(n)), cardinality=n)

    @staticmethod
    def zip(*datasets: "Dataset") -> "Dataset":
        """Element-wise tuples across datasets, stopping at the shortest
        (``Dataset.zip((a, b))`` too); keeps the first input's options."""
        if len(datasets) == 1 and isinstance(datasets[0], (tuple, list)):
            datasets = tuple(datasets[0])
        if not datasets:
            raise ValueError("zip needs at least one dataset")

        def factory():
            its = [iter(d) for d in datasets]
            while True:
                row = []
                for it in its:
                    try:
                        row.append(next(it))
                    except StopIteration:
                        return
                yield tuple(row)

        cards = [d.cardinality() for d in datasets]
        card = (min(cards) if all(c is not None and c >= 0 for c in cards)
                else None)
        return Dataset(factory, options=getattr(datasets[0], "_options", None),
                       cardinality=card)

    # -- combinators (each returns a new Dataset) -------------------------------

    def map(self, fn: Callable) -> "Dataset":
        def factory():
            for el in self._it_factory():
                yield _call(fn, el)

        return self._derive(factory, transform=("map", {"fn": fn}))

    def filter(self, predicate: Callable) -> "Dataset":
        def factory():
            for el in self._it_factory():
                if _call(predicate, el):
                    yield el

        return self._derive(factory, cardinality=None,
                            transform=("filter", {"predicate": predicate}))

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

        return self._derive(factory, transform=("cache", {}))

    def shuffle(self, buffer_size: int, seed: int | None = None,
                reshuffle_each_iteration: bool = True) -> "Dataset":
        """Buffer-based shuffle with tf.data semantics: fill a buffer of
        ``buffer_size``, emit a random occupant, refill. Unseeded, each pass
        (and each process) draws an independent order."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        # Recorded: a seed drawn here is still one per process, which the
        # replicated-determinism guard treats as unseeded.
        auto_seeded = seed is None
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

        return self._derive(
            factory,
            transform=("shuffle",
                       {"buffer_size": buffer_size, "seed": seed,
                        "auto_seeded": auto_seeded,
                        "reshuffle_each_iteration": reshuffle_each_iteration}))

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
        return self._derive(
            factory, cardinality=card,
            transform=("batch", {"batch_size": batch_size,
                                 "drop_remainder": drop_remainder}))

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
        return self._derive(factory, cardinality=card,
                            transform=("repeat", {"count": count}))

    def take(self, count: int) -> "Dataset":
        def factory():
            yield from itertools.islice(self._it_factory(), count)

        card = (None if self._cardinality is None
                else min(count, self._cardinality))
        return self._derive(factory, cardinality=card,
                            transform=("take", {"count": count}))

    def skip(self, count: int) -> "Dataset":
        """Drop the first ``count`` elements."""
        def factory():
            yield from itertools.islice(self._it_factory(), count, None)

        card = (None if self._cardinality is None
                else max(0, self._cardinality - count))
        return self._derive(factory, cardinality=card,
                            transform=("skip", {"count": count}))

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
        return self._derive(factory, cardinality=card,
                            transform=("shard", {"num_shards": num_shards,
                                                 "index": index}))

    def interleave(self, map_func: Callable, cycle_length: int = 4,
                   block_length: int = 1) -> "Dataset":
        """Map each element to a Dataset and consume the streams round-robin,
        ``block_length`` elements at a time from ``cycle_length`` open
        streams. tf.data's order: a stream that ends mid-block passes the
        turn on at once, and its slot opens the next stream only when the
        cycle comes back to it."""
        if cycle_length < 1 or block_length < 1:
            raise ValueError("cycle_length and block_length must be >= 1")

        def factory():
            source = self._it_factory()

            def new_stream():
                try:
                    el = next(source)
                except StopIteration:
                    return None
                return iter(_call(map_func, el))

            slots: list = []
            while len(slots) < cycle_length:
                s = new_stream()
                if s is None:
                    break
                slots.append(s)
            i = 0
            while slots:
                if i >= len(slots):
                    i = 0
                if slots[i] is None:   # an emptied slot, refilled lazily
                    repl = new_stream()
                    if repl is None:
                        slots.pop(i)
                        continue
                    slots[i] = repl
                emitted = 0
                while emitted < block_length:
                    try:
                        yield next(slots[i])
                        emitted += 1
                    except StopIteration:
                        slots[i] = None
                        break
                i += 1

        return self._derive(
            factory, cardinality=None,
            transform=("interleave", {"map_func": map_func,
                                      "cycle_length": cycle_length,
                                      "block_length": block_length}))

    def unbatch(self) -> "Dataset":
        """Split each batched element into per-example elements (the
        leading dim must agree across the element's components)."""
        def first_leaf(el):
            if isinstance(el, tuple):
                return first_leaf(el[0])
            if isinstance(el, dict):
                return first_leaf(next(iter(el.values())))
            return el

        def factory():
            for el in self._it_factory():
                n = len(np.asarray(first_leaf(el)))
                for i in range(n):
                    yield _map_structure(lambda a: np.asarray(a)[i], el)

        return self._derive(factory, cardinality=None,
                            transform=("unbatch", {}))

    def concatenate(self, other: "Dataset") -> "Dataset":
        """This dataset's elements, then ``other``'s."""
        def factory():
            yield from self._it_factory()
            yield from iter(other)

        card = None
        other_card = other.cardinality()
        if (self._cardinality is not None and other_card is not None
                and other_card >= 0):
            card = self._cardinality + other_card
        # Opaque to a chain rewrite: replaying it onto one worker's share
        # would append all of ``other`` to every share.
        return self._derive(factory, cardinality=card, transform=None)

    def prefetch(self, buffer_size: int = 2) -> "Dataset":
        """Produce up to ``buffer_size`` elements ahead on a host thread."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")

        def factory():
            q: queue_lib.Queue = queue_lib.Queue(maxsize=buffer_size)
            stop = threading.Event()
            done = object()

            def put(item) -> bool:
                # Gives up once the consumer has left the iterator (an
                # evaluate(steps=N) that stops early), so the producer
                # never blocks forever on a full queue.
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except queue_lib.Full:
                        continue
                return False

            def producer():
                try:
                    for el in self._it_factory():
                        if not put(el):
                            return
                except BaseException as e:  # raised again in the consumer
                    put((done, e))
                    return
                put((done, None))

            threading.Thread(target=producer, daemon=True).start()
            try:
                while True:  # shardcheck: disable=SC502 -- sentinel-bounded: the producer always puts it
                    item = q.get()
                    if (isinstance(item, tuple) and len(item) == 2
                            and item[0] is done):
                        if item[1] is not None:
                            raise item[1]
                        return
                    yield item
            finally:
                stop.set()

        ds = self._derive(factory,
                          transform=("prefetch", {"buffer_size": buffer_size}))
        ds._prefetched = True
        return ds

    def with_options(self, options: Options) -> "Dataset":
        """Attach options — the auto-shard-policy carrier."""
        ds = self._derive(self._it_factory,
                          transform=("with_options", {"options": options}))
        ds._options = options
        return ds

    # -- introspection ------------------------------------------------------------

    @property
    def options(self) -> Options:
        return self._options

    @property
    def auto_shard_policy(self) -> AutoShardPolicy:
        return self._options.experimental_distribute.auto_shard_policy

    def cardinality(self) -> int | None:
        """Element count if statically known, else None."""
        return self._cardinality

    def __iter__(self) -> Iterator:
        return self._it_factory()

    def as_numpy_iterator(self) -> Iterator:
        return iter(self)

    def _derive(self, factory, cardinality: int | None | str = "inherit",
                transform: tuple[str, dict] | None = None) -> "Dataset":
        ds = Dataset(factory, options=self._options,
                     cardinality=(self._cardinality
                                  if cardinality == "inherit"
                                  else cardinality),
                     num_files=self.num_files)
        ds._parent = self
        ds._transform = transform
        ds._prefetched = self._prefetched
        # The device transform applies after placement, so only a stream
        # shape op keeps it: an element op (map, filter, ...) would see
        # the uint8 wire batch and then be scaled again.
        if transform is not None and transform[0] in _KEEPS_DEVICE_TRANSFORM:
            ds._device_transform = self._device_transform
        return ds

    def _replay_transform(self, transform: tuple[str, dict]) -> "Dataset":
        """Apply a recorded ``(name, kwargs)`` transform to this dataset."""
        name, kw = transform
        if name == "with_options":
            return self.with_options(kw["options"])
        # auto_seeded is a record for the determinism guard, not an argument.
        kw = {k: v for k, v in kw.items() if k != "auto_seeded"}
        return getattr(self, name)(**kw)


class DevicePrefetcher:
    """Batches placed on the card ahead of the step that needs them.

    A producer thread pulls host batches (nests of numpy arrays) from
    ``it`` and, for a CUDA ``device``, places each one on its own
    ``torch.cuda.Stream``: every array is copied to pinned memory and from
    there to the card with ``non_blocking=True``, and an event recorded on
    the producer's stream marks the copies' end. The consumer's stream
    waits on that event before the batch is used (the host never blocks on
    it), and each tensor is recorded on the consumer's stream, so the
    caching allocator reuses its memory only once the consumer's work on
    it is done. Up to ``depth`` batches wait in a bounded queue. ``device``
    defaults to CUDA, by the port's rule (``device="cpu"`` asks for the
    CPU, where the producer is a host thread that makes no copy).

    The queue discipline is :meth:`Dataset.prefetch`'s: the producer
    polls a stop event on every put, so :meth:`close` (the end of an
    epoch loop, ``StopTraining``) never leaves it blocked on a full queue;
    ``close`` stops it, drains the batches in flight and joins the thread.
    ``hits`` and ``misses`` count whether a batch was already waiting when
    the consumer asked (``data.prefetch.hits`` / ``.misses`` counters and
    a ``data.prefetch.depth`` gauge in ``observe/metrics.py``).
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator, *, depth: int = 2, device=None):
        import torch

        from tpu_dist_torch.utils.device import resolve_device

        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.device = resolve_device(device)
        self.hits = 0
        self.misses = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue_lib.Queue = queue_lib.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._produce, args=(it,), daemon=True,
            name="tpu-dist-device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue_lib.Full:
                continue
        return False

    def _place(self, batch):
        """(the batch on the card, the event after its copies), on the
        producer's stream; on the CPU the batch as it is."""
        import torch

        if self._stream is None:
            return batch, None

        def place(a):
            host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            placed = _map_structure(place, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _produce(self, it: Iterator) -> None:
        try:
            for batch in it:
                if not self._put(self._place(batch)):
                    return
        except BaseException as e:  # raised again in the consumer
            self._put((self._SENTINEL, e))
            return
        self._put((self._SENTINEL, None))

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        import torch

        from tpu_dist_torch.observe import metrics

        if self._exhausted:
            raise StopIteration
        buffered = self._q.qsize()
        metrics.set_gauge("data.prefetch.depth", buffered)
        item, event = self._q.get()
        if item is self._SENTINEL:
            self._exhausted = True
            if event is not None:
                raise event
            raise StopIteration
        if buffered > 0:
            self.hits += 1
            metrics.inc("data.prefetch.hits")
        else:
            self.misses += 1
            metrics.inc("data.prefetch.misses")
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _map_structure(lambda t: t.record_stream(stream), item)
        return item

    @property
    def closed(self) -> bool:
        """True once close() has torn down the producer thread."""
        return self._stop.is_set() and not self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer, drain the batches in flight, join the thread.
        Idempotent, and safe in the middle of a stream."""
        self._stop.set()
        self._exhausted = True
        while True:   # a producer blocked in put() then sees the stop
            try:
                self._q.get_nowait()
            except queue_lib.Empty:
                break
        self._thread.join(timeout=timeout)
