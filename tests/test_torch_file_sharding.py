"""AutoShardPolicy.FILE in the port against the reference's, on the CPU.

Each case of ``tests/test_file_sharding.py`` runs in both packages on the
same shard files, written once by each package (``writer``) and read by
both: the element streams, the strided per-worker subsets, the rebatched
global batches and the cardinalities must be equal exactly;
``resolve_policy`` must make the same AUTO decisions; the same conditions
must raise ``ValueError`` in both; and stale or incomplete generations are
handled alike. A ``fit`` over the file-backed chain (the host-fed path,
as in the reference, which vectorizes only in-memory sources) matches the
reference's on bridged weights at atol 1e-5.
"""

import jax
import numpy as np
import pytest

from tpu_dist.data import pipeline as jpipeline
from tpu_dist.data import sharding as jsharding
from tpu_dist.data import sources as jsources
from tpu_dist.models import cnn as jcnn
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch import data
from tpu_dist_torch.data import pipeline, sharding, sources, vectorize
from tpu_dist_torch.models import cnn
from tpu_dist_torch.models.bridge import params_from_jax
from tpu_dist_torch.ops import losses
from tpu_dist_torch.ops import optimizers as opt

WRITERS = {"torch": sources.write_sharded, "jax": jsources.write_sharded}
TOL = dict(atol=1e-5, rtol=1e-5)


def _toy_arrays(n=48):
    images = np.arange(n * 4, dtype=np.uint8).reshape(n, 2, 2, 1)
    labels = (np.arange(n) % 10).astype(np.int64)
    return images, labels


@pytest.fixture(params=sorted(WRITERS))
def writer(request):
    return WRITERS[request.param]


@pytest.fixture
def shard_dir(tmp_path, monkeypatch, writer):
    """Four mnist-train shard files under a fresh $TPU_DIST_DATA_DIR."""
    images, labels = _toy_arrays()
    writer(tmp_path, "mnist", "train", images, labels, 4)
    monkeypatch.setenv(sources.DATA_DIR_ENV, str(tmp_path))
    return tmp_path


def _both(make):
    """``make(sources, sharding, AutoShardPolicy)`` in each package."""
    return (make(sources, sharding, data.AutoShardPolicy),
            make(jsources, jsharding, jpipeline.AutoShardPolicy))


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


def _elements(ds):
    return [(int(x.reshape(-1)[0]), int(y)) for x, y in ds]


def _raises_alike(make, match):
    for src, shd, P in ((sources, sharding, data.AutoShardPolicy),
                        (jsources, jsharding, jpipeline.AutoShardPolicy)):
        with pytest.raises(ValueError, match=match):
            make(src, shd, P)


# -- from_files ---------------------------------------------------------------


def test_from_files_reads_all_files_in_order(tmp_path):
    for i in range(3):
        np.save(tmp_path / f"f{i}.npy", np.arange(i * 10, i * 10 + 5))
    files = sorted(tmp_path.glob("f*.npy"))
    ours = pipeline.Dataset.from_files(files, lambda p: iter(np.load(p)))
    ref = jpipeline.Dataset.from_files(files, lambda p: iter(np.load(p)))
    assert ours.num_files == ref.num_files == 3
    got = _assert_same(ours, ref)
    assert [int(v) for v in got] == [*range(0, 5), *range(10, 15),
                                     *range(20, 25)]


@pytest.mark.parametrize("kwargs", [
    {}, {"file_cardinalities": [1, 2]}, {"file_cardinalities": [1],
                                         "cardinality": None},
    {"file_cardinalities": [1, 1], "cardinality": 3}])
def test_from_files_errors_match_reference(kwargs, tmp_path):
    files = [] if not kwargs else [tmp_path / "a", tmp_path / "b"]
    if kwargs.get("file_cardinalities") == [1, 2]:
        # A well-formed call: both build, with the same cardinality.
        ours = pipeline.Dataset.from_files(files, iter, **kwargs)
        ref = jpipeline.Dataset.from_files(files, iter, **kwargs)
        assert ours.cardinality() == ref.cardinality() == 3
        return
    for D in (pipeline.Dataset, jpipeline.Dataset):
        with pytest.raises(ValueError):
            D.from_files(files, iter, **kwargs)


# -- FILE sharding ------------------------------------------------------------


def test_load_serves_the_shards_as_the_reference_does(shard_dir):
    ours, ref = _both(lambda src, shd, P: src.load("mnist", "train"))
    assert ours.num_files == ref.num_files == 4
    assert ours.cardinality() == ref.cardinality() == 48
    _assert_same(ours, ref)
    ours, ref = _both(lambda src, shd, P: src.load(
        "mnist", "train", as_supervised=False))
    _assert_same(ours, ref)


def test_strided_disjoint_union(shard_dir):
    full = _elements(sources.load("mnist", "train"))
    e = []
    for i in range(2):
        ours, ref = _both(lambda src, shd, P: shd.shard_dataset(
            src.load("mnist", "train"), 2, i, P.FILE))
        _assert_same(ours, ref)
        e.append(_elements(ours))
    assert not set(e[0]) & set(e[1])
    assert sorted(set(e[0]) | set(e[1])) == sorted(full)
    assert len(e[0]) == len(e[1]) == 24
    # Worker i reads files i, i + 2 (TF's stride): a direct read of them.
    files = sorted(shard_dir.glob("mnist-train.shard-*.npz"))
    direct = [(int(x.reshape(-1)[0]), int(y))
              for f in files[0::2] for x, y in sources._read_shard(f)]
    assert e[0] == direct


def test_chain_rewrite_through_map_cache(shard_dir):
    ours, ref = _both(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train").map(
            lambda x, y: (x.astype(np.float32) / 255.0, y)).cache(),
        4, 0, P.FILE))
    got = _assert_same(ours, ref)
    assert len(got) == 12
    assert got[0][0].dtype == np.float32


@pytest.mark.parametrize("index", [0, 1])
def test_pre_batched_rebatches_global_to_per_worker(shard_dir, index):
    ours, ref = _both(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train").batch(24), 2, index, P.FILE,
        pre_batched=True))
    batches = _assert_same(ours, ref)
    assert [b[0].shape[0] for b in batches] == [12, 12]
    other = sharding.shard_dataset(sources.load("mnist", "train").batch(24),
                                   2, 1 - index, data.AutoShardPolicy.FILE,
                                   pre_batched=True)
    ids = {int(x.reshape(-1)[0]) for b in batches for x in b[0]}
    ids1 = {int(x.reshape(-1)[0]) for b in other for x in b[0]}
    assert not ids & ids1


def test_rebatch_indivisible_raises(shard_dir):
    _raises_alike(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train").batch(25), 2, 0, P.FILE,
        pre_batched=True), "not divisible")


def test_too_few_files_raises(shard_dir):
    _raises_alike(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train"), 8, 0, P.FILE), "FILE requires")


def test_in_memory_source_raises():
    _raises_alike(lambda src, shd, P: shd.shard_dataset(
        src.Dataset.from_tensor_slices((np.zeros((8, 2)), np.zeros(8))),
        2, 0, P.FILE), "FILE requires")


def test_opaque_link_refuses_file_policy(shard_dir):
    # A link without a recorded transform cannot be replayed on a subset.
    def make(src, shd, P):
        ds = src.load("mnist", "train")
        return ds._derive(lambda: iter(ds))
    ours, ref = _both(make)
    assert (sharding.resolve_policy(ours, 2, data.AutoShardPolicy.AUTO)
            == data.AutoShardPolicy.DATA)
    assert (jsharding.resolve_policy(ref, 2, jpipeline.AutoShardPolicy.AUTO)
            == jpipeline.AutoShardPolicy.DATA)
    _raises_alike(lambda src, shd, P: shd.shard_dataset(
        make(src, shd, P), 2, 0, P.FILE), "file-backed")


def test_cardinality_known_from_headers(shard_dir):
    ours, ref = _both(lambda src, shd, P: src.load("mnist", "train"))
    assert ours.cardinality() == ref.cardinality() == 48


def test_sharded_subset_keeps_cardinality(shard_dir):
    ours, ref = _both(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train").batch(12), 2, 0, P.FILE,
        pre_batched=True))
    assert ours.cardinality() == ref.cardinality() == 4
    _assert_same(ours, ref)


def test_uneven_file_split_raises(shard_dir):
    _raises_alike(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train"), 3, 0, P.FILE), "evenly")


@pytest.mark.parametrize("counts,policy", [
    ((100, 50, 50, 50), "DATA"), ((100, 50, 50, 100), "FILE")])
def test_per_file_counts_decide_the_file_policy(tmp_path, counts, policy):
    for i, n in enumerate(counts):
        np.save(tmp_path / f"u{i}.npy", np.arange(n))
    files = sorted(tmp_path.glob("u*.npy"))

    def make(src, shd, P):
        return src.Dataset.from_files(files, lambda p: iter(np.load(p)),
                                      file_cardinalities=list(counts))
    ours, ref = _both(make)
    assert (sharding.resolve_policy(ours, 2, data.AutoShardPolicy.AUTO).name
            == jsharding.resolve_policy(
                ref, 2, jpipeline.AutoShardPolicy.AUTO).name == policy)
    if policy == "DATA":
        _raises_alike(lambda src, shd, P: shd.shard_dataset(
            make(src, shd, P), 2, 0, P.FILE), "evenly")
    else:
        for i in range(2):
            _assert_same(
                sharding.shard_dataset(ours, 2, i, data.AutoShardPolicy.FILE),
                jsharding.shard_dataset(ref, 2, i,
                                        jpipeline.AutoShardPolicy.FILE))


def test_stale_generation_not_mixed(shard_dir, tmp_path, writer):
    images, labels = _toy_arrays()
    writer(tmp_path, "mnist", "train", images, labels, 8)
    ours, ref = _both(lambda src, shd, P: src.load("mnist", "train"))
    assert ours.num_files == ref.num_files
    assert ours.num_files in (4, 8)
    assert ours.cardinality() == ref.cardinality() == 48
    _assert_same(ours, ref)


def test_incomplete_generation_ignored(tmp_path, monkeypatch, writer):
    images, labels = _toy_arrays()
    paths = writer(tmp_path, "mnist", "train", images, labels, 4)
    paths[2].unlink()
    monkeypatch.setenv(sources.DATA_DIR_ENV, str(tmp_path))
    ours, ref = _both(lambda src, shd, P: src.load("mnist", "train",
                                                   synthetic_size=16))
    assert ours.num_files == ref.num_files == 1
    _assert_same(ours, ref)


# -- AUTO ---------------------------------------------------------------------


@pytest.mark.parametrize("workers,want", [(2, "FILE"), (4, "FILE"),
                                          (8, "DATA"), (3, "DATA"),
                                          (1, "DATA")])
def test_auto_decisions_match_reference(shard_dir, workers, want):
    ours, ref = _both(lambda src, shd, P: src.load("mnist", "train"))
    assert (sharding.resolve_policy(ours, workers,
                                    data.AutoShardPolicy.AUTO).name
            == jsharding.resolve_policy(
                ref, workers, jpipeline.AutoShardPolicy.AUTO).name == want)


def test_auto_falls_back_for_in_memory_source():
    ours, ref = _both(lambda src, shd, P: src.Dataset.from_tensor_slices(
        (np.zeros((8, 2)), np.zeros(8))))
    assert (sharding.resolve_policy(ours, 2, data.AutoShardPolicy.AUTO)
            == data.AutoShardPolicy.DATA)
    assert (jsharding.resolve_policy(ref, 2, jpipeline.AutoShardPolicy.AUTO)
            == jpipeline.AutoShardPolicy.DATA)


@pytest.mark.parametrize("index", [0, 1])
def test_auto_end_to_end_shards_by_file(shard_dir, index):
    ours, ref = _both(lambda src, shd, P: shd.shard_dataset(
        src.load("mnist", "train"), 2, index, P.AUTO))
    _assert_same(ours, ref)
    other = sharding.shard_dataset(sources.load("mnist", "train"), 2,
                                   1 - index, data.AutoShardPolicy.AUTO)
    e0, e1 = set(_elements(ours)), set(_elements(other))
    assert not e0 & e1 and len(e0 | e1) == 48


# -- write_sharded ------------------------------------------------------------


def test_write_sharded_files_are_byte_equal_and_round_trip(tmp_path):
    images, labels = _toy_arrays(30)
    a = sources.write_sharded(tmp_path / "a", "cifar10", "test", images,
                              labels, 3)
    b = jsources.write_sharded(tmp_path / "b", "cifar10", "test", images,
                               labels, 3)
    assert [p.name for p in a] == [p.name for p in b]
    back = []
    for pa, pb in zip(a, b):
        with np.load(pa) as za, np.load(pb) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
            back.extend(int(v) for v in za["labels"])
    assert sorted(back) == sorted(int(v) for v in labels)


@pytest.mark.parametrize("num_shards", [0, 9])
def test_bad_shard_count_raises(tmp_path, num_shards):
    images, labels = _toy_arrays(4)
    for write in WRITERS.values():
        with pytest.raises(ValueError):
            write(tmp_path, "mnist", "train", images, labels, num_shards)


# -- the distributed-dataset path and fit -------------------------------------


def test_distribute_reaches_the_rebatching_file_branch(shard_dir,
                                                       monkeypatch):
    """The pre-batched path of ``DistributedDataset`` FILE-shards and
    rebatches as the reference's ``shard_dataset(pre_batched=True)``."""
    from tpu_dist_torch.data import distribute

    monkeypatch.setattr(distribute.bootstrap, "process_count", lambda: 2)
    for index in range(2):
        monkeypatch.setattr(distribute.bootstrap, "process_index",
                            lambda: index)
        dist = distribute.DistributedDataset(
            sources.load("mnist", "train").batch(24), None, prefetch=None)
        assert dist.auto_shard_policy == data.AutoShardPolicy.FILE
        ref = jsharding.shard_dataset(
            jsources.load("mnist", "train").batch(24), 2, index,
            jpipeline.AutoShardPolicy.AUTO, pre_batched=True)
        assert dist.cardinality() == ref.cardinality() == 2
        _assert_same(dist, ref)


def test_fit_on_a_file_backed_chain_matches_reference(tmp_path, monkeypatch):
    images, labels = sources.load_arrays("mnist", synthetic_size=256)
    sources.write_sharded(tmp_path, "mnist", "train", images, labels, 4)
    monkeypatch.setenv(sources.DATA_DIR_ENV, str(tmp_path))

    def chain(src):
        return (src.load("mnist", split="train")
                .map(lambda x, y: (np.asarray(x, np.float32) / 255.0, y))
                .cache().batch(32))

    ours = chain(sources)
    # Not promoted or rewritten: the chain roots in files.
    assert vectorize.try_rewrite(ours, device="cpu") is None
    jmodel = jcnn.build_cnn_model()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(0)["params"])
    model = cnn.build_cnn_model()
    model.load_jax_params(params)
    jmodel.compile(optimizer=jopt.SGD(learning_rate=0.01),
                   loss=jlosses.SparseCategoricalCrossentropy(
                       from_logits=True))
    model.compile(optimizer=opt.SGD(learning_rate=0.01),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                  device="cpu")
    jh = jmodel.fit(chain(jsources), epochs=2, steps_per_epoch=4,
                    verbose=0).history
    th = model.fit(ours, epochs=2, steps_per_epoch=4, verbose=0).history
    np.testing.assert_allclose(th["loss"], [float(v) for v in jh["loss"]],
                               **TOL)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.variables["params"]))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
