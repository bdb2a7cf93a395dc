"""The port's input pipeline and cluster config against the reference's.

The reference program's chain (``load -> map(scale) -> cache ->
shuffle(seed) -> batch``) is built in both packages from the same
synthetic MNIST, and must yield identical batches pass after pass; the
OFF, AUTO and DATA shard policies must give each of 2 processes the
reference's slice; TF_CONFIG must parse to the same cluster identity. All
exact: the port keeps a numpy copy of the reference's pipeline.
"""

import json

import numpy as np
import pytest
import torch

from tpu_dist.cluster import config as jconfig
from tpu_dist.data import pipeline as jpipeline
from tpu_dist.data import sharding as jsharding
from tpu_dist.data import sources as jsources
from tpu_dist.parallel import strategy as jstrategy
from tpu_dist_torch import data, parallel
from tpu_dist_torch.cluster import bootstrap, config
from tpu_dist_torch.data import sharding
from tpu_dist_torch.models.cnn import build_and_compile_cnn_model


def _scale(image, label):
    return np.asarray(image, np.float32) / 255.0, label


def _chains(batch=64, seed=3, buffer=1000, size=512):
    """The reference program's chain in both packages (the port's first)."""
    return [m.load("mnist", split="train", synthetic_size=size)
            .map(_scale).cache().shuffle(buffer, seed=seed).batch(batch)
            for m in (data, jsources)]


def _assert_same_stream(a, b):
    """One pass of each; returns the port's batches."""
    got, want = list(a), list(b)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    return got


def test_reference_chain_yields_identical_batches_every_pass():
    ours, ref = _chains()
    assert ours.cardinality() == ref.cardinality() == 8
    for _ in range(3):   # a seeded shuffle draws seed + pass on each pass
        _assert_same_stream(ours, ref)


def test_combinators_match_reference():
    x = np.arange(23 * 3).reshape(23, 3)
    y = np.arange(23)
    ours = data.Dataset.from_tensor_slices((x, y))
    ref = jpipeline.Dataset.from_tensor_slices((x, y))
    for make in (lambda d: d.batch(5), lambda d: d.batch(5, True),
                 lambda d: d.take(7).repeat(2).batch(3),
                 lambda d: d.shard(3, 1).batch(4),
                 lambda d: d.shuffle(4, seed=11,
                                     reshuffle_each_iteration=False).batch(6)):
        a, b = make(ours), make(ref)
        assert a.cardinality() == b.cardinality()
        _assert_same_stream(a, b)


@pytest.mark.parametrize("policy", ["OFF", "AUTO", "DATA", "HINT"])
def test_shard_policies_give_reference_slices(policy):
    ours, ref = _chains(size=256)
    for index in range(2):
        a = sharding.shard_dataset(ours, 2, index,
                                   data.AutoShardPolicy[policy],
                                   pre_batched=True)
        b = jsharding.shard_dataset(ref, 2, index,
                                    jpipeline.AutoShardPolicy[policy],
                                    pre_batched=True)
        got = _assert_same_stream(a, b)
        assert {len(bx) for bx, _ in got} == {64 if policy == "OFF" else 32}


def test_data_sharding_refuses_a_batch_the_workers_do_not_divide():
    ds = data.Dataset.from_tensor_slices(np.arange(10)).batch(5)
    with pytest.raises(ValueError, match="not divisible"):
        list(sharding.shard_dataset(ds, 2, 0, data.AutoShardPolicy.DATA,
                                    pre_batched=True))
    with pytest.raises(ValueError, match="file-backed"):
        sharding.shard_dataset(ds, 2, 0, data.AutoShardPolicy.FILE)


def test_options_carry_the_policy_through_the_chain():
    options = data.Options()
    options.experimental_distribute.auto_shard_policy = \
        data.AutoShardPolicy.OFF
    ds = data.load("mnist", split="train", synthetic_size=64).with_options(
        options).batch(8)
    assert ds.auto_shard_policy == data.AutoShardPolicy.OFF
    assert int(data.AutoShardPolicy.OFF) == int(
        jpipeline.AutoShardPolicy.OFF)
    # One process: the distributed dataset is the stream itself.
    dist = data.DistributedDataset(ds, strategy=None)
    assert dist.cardinality() == 8
    _assert_same_stream(dist, ds)


def test_load_with_info_matches_reference():
    (ours, info) = data.load(name="mnist", with_info=True, synthetic_size=32)
    (ref, jinfo) = jsources.load(name="mnist", with_info=True,
                                 synthetic_size=32)
    assert sorted(ours) == sorted(ref) == ["test", "train"]
    _assert_same_stream(ours["train"].batch(32), ref["train"].batch(32))
    assert info.splits["train"].num_examples == 32
    assert info.synthetic == jinfo.synthetic
    assert (info.image_shape, info.num_classes) == (jinfo.image_shape,
                                                    jinfo.num_classes)


@pytest.mark.parametrize("tf_config", [
    {"cluster": {"worker": ["a:1", "b:2", "c:3"]},
     "task": {"type": "worker", "index": 2}},
    {"cluster": {"chief": ["c:9"], "worker": ["a:1", "a:2"]},
     "task": {"type": "worker", "index": 1}},
    {"cluster": {"worker": ["127.0.0.1:5000"]},
     "task": {"type": "worker", "index": 0}},
])
def test_tf_config_parses_like_reference(tf_config):
    env = {"TF_CONFIG": json.dumps(tf_config)}
    ours, ref = config.ClusterConfig.from_env(env), \
        jconfig.ClusterConfig.from_env(env)
    for attr in ("is_chief", "process_id", "num_processes", "task_address",
                 "coordinator_address"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert config.ClusterConfig.from_env({}) is None
    assert config.make_local_cluster(3, base_port=7000) == \
        jconfig.make_local_cluster(3, base_port=7000)
    with pytest.raises(config.ClusterConfigError):
        config.ClusterConfig.from_json('{"cluster": {"worker": ["x"]}}')


def test_strategy_surface_in_one_process():
    strategy = parallel.MultiWorkerMirroredStrategy("ring", device="cpu")
    # RING is TF's collective implementation without NCCL: gloo, on the
    # CPU as on CUDA; NCCL needs CUDA.
    assert strategy.communication is parallel.CollectiveCommunication.RING
    cpu = torch.device("cpu")
    assert bootstrap.backend_for(strategy.communication.name, cpu) == "gloo"
    assert bootstrap.backend_for("AUTO", cpu) == "gloo"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        bootstrap.backend_for("NCCL", cpu)
    assert strategy.num_replicas_in_sync == 1 and strategy.is_chief
    assert strategy.device.type == "cpu"
    assert not parallel.has_strategy()
    default = parallel.get_strategy()
    assert default.device is None and default is parallel.get_strategy()
    with strategy.scope():
        assert parallel.get_strategy() is strategy and parallel.has_strategy()
        model = build_and_compile_cnn_model()   # the scoped strategy's device
    assert model.strategy is strategy
    assert next(model.parameters()).device.type == "cpu"
    # reduce() of per-replica values, leaf by leaf, as the reference's.
    values = {"a": np.arange(6.0).reshape(3, 2), "b": (np.ones(4), 2.0)}
    for op in ("sum", "mean"):
        got = strategy.reduce(op, values)
        want = jstrategy.Strategy.reduce(None, op, values)
        np.testing.assert_allclose(got["a"], want["a"])
        np.testing.assert_allclose(got["b"][0], want["b"][0])
        assert float(got["b"][1]) == float(want["b"][1])
    # run() on the one replica: its result stacked on a replica axis.
    out = strategy.run(lambda a: a * 2.0, args=(np.ones(3, np.float32),))
    assert out.shape == (1, 3) and out.tolist() == [[2.0, 2.0, 2.0]]
    with pytest.raises(ValueError, match="unknown CollectiveCommunication"):
        parallel.CollectiveCommunication.resolve("gossip")
    # One process: a collective is the identity.
    t = [np.float32(3.0)]
    assert parallel.all_reduce(t, "mean") is t


def test_local_device_index_counts_ranks_on_the_same_host():
    cfg = config.ClusterConfig.from_json({
        "cluster": {"worker": ["h1:1", "h2:1", "h1:2", "h1:3"]},
        "task": {"type": "worker", "index": 3}})
    # Worker 3 is the third task on host h1: it takes cuda:2, and a host
    # with fewer cards refuses (NCCL cannot put two ranks on one card).
    assert bootstrap.local_device_index(cfg) == 2
    assert [bootstrap.local_device_index(config.ClusterConfig.from_json(
        {"cluster": {"worker": ["h:1", "h:2"]},
         "task": {"type": "worker", "index": i}})) for i in (0, 1)] == [0, 1]


def test_cuda_device_maps_tasks_onto_cards_and_refuses_a_shared_card(
        monkeypatch):
    # Four workers on one host: with four cards each takes its own; with
    # two, the third worker would share a card under NCCL and is refused.
    tf_configs = config.make_local_cluster(4)
    cfgs = [config.ClusterConfig.from_json(c) for c in tf_configs]
    monkeypatch.setattr(bootstrap.torch.cuda, "device_count", lambda: 4)
    assert [bootstrap._cuda_device(c) for c in cfgs] == [
        torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(bootstrap.torch.cuda, "device_count", lambda: 2)
    assert bootstrap._cuda_device(cfgs[1]) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        bootstrap._cuda_device(cfgs[2])


def test_gloo_workers_share_the_cards_in_turn(monkeypatch):
    # Under gloo (communication="ring") several workers may share a card:
    # a worker takes the card of its index on the host modulo their count.
    cfgs = [config.ClusterConfig.from_json(c)
            for c in config.make_local_cluster(3)]
    monkeypatch.setattr(bootstrap.torch.cuda, "device_count", lambda: 2)
    assert [bootstrap._cuda_device(c, "gloo") for c in cfgs] == [
        torch.device("cuda", i) for i in (0, 1, 0)]
    assert bootstrap.backend_for("ring", torch.device("cuda")) == "gloo"
    assert bootstrap.backend_for("AUTO", torch.device("cuda")) == "nccl"
    with pytest.raises(ValueError, match="unknown"):
        bootstrap.backend_for("gossip", torch.device("cpu"))
