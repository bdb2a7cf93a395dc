"""The port's Dataset members, chain record and prefetchers against the
reference's.

Each member the port adds (``range``, ``from_generator``, ``filter``,
``interleave``, ``skip``, ``unbatch``, ``concatenate``, ``zip``,
``prefetch``, ``options``, ``as_numpy_iterator``) runs in both packages on
the same numpy source, and the element streams and cardinalities must be
equal, exactly. The chain record (``_parent``, ``_transform``,
``_tensor_source``, ``_device_transform``, ``_prefetched``, ``num_files``)
must read as the reference's, since ``data/vectorize.py`` parses it.
``DevicePrefetcher`` on the CPU is a host thread that makes no copy: it
yields the stream unchanged, counts hits and misses, raises the
producer's error and tears down on ``close``.
"""

import numpy as np
import pytest

from tpu_dist.data import distribute as jdistribute
from tpu_dist.data import pipeline as jpipeline
from tpu_dist.data import sources as jsources
from tpu_dist_torch import data
from tpu_dist_torch.data import distribute, pipeline, sources

X = np.arange(23 * 3).reshape(23, 3)
Y = np.arange(23)


def _pair(make):
    """``make(Dataset)`` in the port and in the reference."""
    return make(pipeline.Dataset), make(jpipeline.Dataset)


def _assert_same(a, b):
    got, want = list(a), list(b)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gl, wl = [], []
        pipeline._map_structure(gl.append, g)
        jpipeline._map_structure(wl.append, w)
        assert len(gl) == len(wl)
        for ga, wa in zip(gl, wl):
            ga, wa = np.asarray(ga), np.asarray(wa)
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
    return got


def _slices(D):
    return D.from_tensor_slices((X, Y))


MEMBERS = {
    "range": lambda D: D.range(9).batch(4),
    "from_generator": lambda D: D.from_generator(
        lambda: iter(range(5))).repeat(2),
    "filter": lambda D: _slices(D).filter(lambda a, b: b % 3 != 1).batch(4),
    "interleave": lambda D: D.range(5).interleave(
        lambda i: D.range(int(i) + 1).map(lambda v: v * 10 + i),
        cycle_length=3, block_length=2),
    "skip": lambda D: _slices(D).skip(5).batch(6),
    "skip_past_end": lambda D: _slices(D).skip(40),
    "unbatch": lambda D: _slices(D).batch(5).unbatch(),
    "concatenate": lambda D: _slices(D).take(4).concatenate(
        _slices(D).skip(20)),
    "zip": lambda D: D.zip(D.range(7), _slices(D).batch(3)),
    "zip_tuple": lambda D: D.zip((D.range(3), D.range(5))),
    "prefetch": lambda D: _slices(D).shuffle(8, seed=4).prefetch(3).batch(5),
}


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_member_streams_match_reference(member):
    ours, ref = _pair(MEMBERS[member])
    assert ours.cardinality() == ref.cardinality()
    _assert_same(ours, ref)
    _assert_same(ours.as_numpy_iterator(), ref.as_numpy_iterator())


def test_members_refuse_what_the_reference_refuses():
    for D in (pipeline.Dataset, jpipeline.Dataset):
        with pytest.raises(ValueError):
            D.range(4).interleave(lambda i: D.range(2), cycle_length=0)
        with pytest.raises(ValueError):
            D.range(4).prefetch(0)
        with pytest.raises(ValueError):
            D.zip()


def test_prefetch_raises_the_producers_error_and_leaves_early():
    def bad(v):
        if v == 3:
            raise KeyError("boom")
        return v

    ds = data.Dataset.range(6).map(bad).prefetch(2)
    with pytest.raises(KeyError):
        list(ds)
    it = iter(data.Dataset.range(1000).prefetch(2))
    assert next(it) == 0
    it.close()   # sets the stop event the producer polls


def _chain(D, src):
    def scale(image, label):
        return np.asarray(image, np.float32) / 255.0, label

    options = (data.Options() if D is pipeline.Dataset
               else jpipeline.Options())
    options.experimental_distribute.auto_shard_policy = -1
    return (src.map(scale).cache().shuffle(100, seed=3).batch(16)
            .prefetch(2).with_options(options).take(3))


def test_chain_record_reads_as_the_references():
    ours = _chain(pipeline.Dataset, data.load("mnist", split="train",
                                               synthetic_size=64))
    ref = _chain(jpipeline.Dataset, jsources.load("mnist", split="train",
                                                  synthetic_size=64))
    a, b = ours, ref
    while b is not None:
        assert a is not None
        assert (a._transform is None) == (b._transform is None)
        if b._transform is not None:
            (an, akw), (bn, bkw) = a._transform, b._transform
            assert an == bn and sorted(akw) == sorted(bkw)
            for k, v in bkw.items():
                if not callable(v) and k != "options":
                    assert akw[k] == v, (an, k)
        assert a._prefetched == b._prefetched
        assert a.num_files == b.num_files
        assert a.cardinality() == b.cardinality()
        assert (a._tensor_source is None) == (b._tensor_source is None)
        a, b = a._parent, b._parent
    assert a is None
    # The source holds its arrays.
    src = ours
    while src._parent is not None:
        src = src._parent
    np.testing.assert_array_equal(src._tensor_source[0], sources.load_arrays(
        "mnist", "train", synthetic_size=64)[0])
    assert ours.options is ours._options
    assert int(ours.auto_shard_policy) == int(ref.auto_shard_policy) == -1
    # A replayed record rebuilds the same stream.
    base = data.Dataset.from_tensor_slices((X, Y))
    replayed = base
    for node in reversed([n for n in _walk(_slices(pipeline.Dataset).skip(2)
                                           .shuffle(5, seed=1).batch(4))
                          if n._transform is not None]):
        replayed = replayed._replay_transform(node._transform)
    _assert_same(replayed, _slices(jpipeline.Dataset).skip(2)
                 .shuffle(5, seed=1).batch(4))


def _walk(ds):
    while ds is not None:
        yield ds
        ds = ds._parent


def test_device_transform_survives_only_stream_shape_ops():
    base = data.Dataset.from_tensor_slices((X, Y))
    base._device_transform = t = (lambda x: x)
    for keeps in (lambda d: d.batch(2), lambda d: d.repeat(2),
                  lambda d: d.take(3), lambda d: d.skip(1),
                  lambda d: d.shard(2, 0), lambda d: d.prefetch(1),
                  lambda d: d.with_options(data.Options())):
        assert keeps(base)._device_transform is t
    for drops in (lambda d: d.map(lambda a, b: (a, b)),
                  lambda d: d.filter(lambda a, b: True), lambda d: d.cache(),
                  lambda d: d.shuffle(4), lambda d: d.unbatch(),
                  lambda d: d.concatenate(d)):
        assert drops(base)._device_transform is None


def test_device_prefetcher_on_the_cpu_yields_the_stream():
    batches = list(data.Dataset.from_tensor_slices((X, Y)).batch(4))
    pf = data.DevicePrefetcher(iter(batches), depth=2, device="cpu")
    got = list(pf)
    assert len(got) == len(batches)
    for (gx, gy), (wx, wy) in zip(got, batches):
        assert gx is wx and gy is wy   # no copy on the CPU
    assert pf.hits + pf.misses == len(batches)
    pf.close()
    assert pf.closed
    with pytest.raises(StopIteration):
        next(pf)


def test_device_prefetcher_raises_and_closes_mid_stream():
    def gen():
        yield 1
        raise RuntimeError("producer failed")

    pf = data.DevicePrefetcher(gen(), depth=1, device="cpu")
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)
    endless = data.DevicePrefetcher(iter(range(10**9)), depth=2,
                                     device="cpu")
    assert next(endless) == 0
    endless.close(timeout=5.0)
    assert endless.closed
    endless.close()   # idempotent
    with pytest.raises(ValueError):
        data.DevicePrefetcher(iter(()), depth=0, device="cpu")


def test_device_prefetcher_defaults_to_cuda(monkeypatch):
    # The port's rule: no device means CUDA, and without a card that
    # raises before any producer thread starts; it never runs on the CPU.
    import threading

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        data.DevicePrefetcher(iter(range(3)), depth=2)
    assert threading.active_count() == before


def test_replicated_determinism_guard_matches_reference():
    for seeded in (None, 5):
        ours = data.Dataset.range(8).shuffle(4, seed=seeded).batch(2)
        ref = jpipeline.Dataset.range(8).shuffle(4, seed=seeded).batch(2)
        for shards, procs in ((2, 2), (1, 2)):
            outcomes = []
            for fn, ds in ((distribute.check_replicated_determinism, ours),
                           (jdistribute.check_replicated_determinism, ref)):
                try:
                    fn(ds, shards, procs, "AutoShardPolicy.OFF")
                    outcomes.append("ok")
                except ValueError:
                    outcomes.append("raised")
            assert outcomes[0] == outcomes[1], (seeded, shards, procs)
            assert outcomes[0] == ("raised" if seeded is None and shards < procs
                                   else "ok")


def test_distributed_dataset_rewrites_and_prefetches():
    def scale(image, label):
        return np.asarray(image, np.float32) / 255.0, label

    ds = (data.load("mnist", split="train", synthetic_size=256).map(scale)
          .cache().shuffle(1000, seed=5).batch(64))
    dist = data.DistributedDataset(ds, strategy=None)
    assert dist._local._prefetched and dist.device_transform is None
    node = dist._local
    while node is not None and not getattr(node, "_vectorized", False):
        node = node._parent
    assert node is not None
    def ref():
        return (jsources.load("mnist", split="train", synthetic_size=256)
                .map(scale).cache().shuffle(1000, seed=5).batch(64))

    _assert_same(dist.iter_local(), ref())
    # The trainer's wrap on a device other than the CPU ships uint8 and
    # scales on the device; a user's own loop still gets float32.
    wire = data.DistributedDataset(ds, strategy=None,
                                   allow_device_transform=True,
                                   device="cuda")
    t = wire.device_transform
    assert (t._op, t._scale) == ("div", 255.0)
    for (gx, gy), (wx, wy) in zip(wire, ref()):
        assert gx.dtype == np.uint8
        np.testing.assert_array_equal(t(gx).numpy(), wx)
        np.testing.assert_array_equal(gy, wy)
    cpu = data.DistributedDataset(ds, strategy=None,
                                  allow_device_transform=True, device="cpu")
    assert cpu.device_transform is None


def test_num_classes_and_image_shape_match_reference():
    for name in ("mnist", "fashion_mnist", "cifar10"):
        assert data.num_classes(name) == jsources.num_classes(name)
        assert data.image_shape(name) == jsources.image_shape(name)


def test_prefetchers_keep_order_under_thread_switching():
    # Producers and consumers switched every microsecond: every element
    # arrives once, in order, and close() ends each producer thread.
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        streams = [data.DevicePrefetcher(iter(range(2000)), depth=d,
                                         device="cpu")
                   for d in (1, 3)]
        for pf in streams:
            assert list(pf) == list(range(2000))
            pf.close(timeout=5.0)
            assert pf.closed
        chained = data.Dataset.range(2000).prefetch(1).map(
            lambda v: v * 2).prefetch(4)
        assert list(chained) == [2 * v for v in range(2000)]
    finally:
        sys.setswitchinterval(old)
