"""The port's collectives against the reference's, on the CPU.

``partition_buckets`` must give the reference's index lists on the same
trees: the narrow BatchNorm ResNet of ``test_torch_sync_bn.py`` and a
narrow LM (their parameter trees, the port's built from its named
parameters, the reference's from ``init(0)``), a tree mixing dtypes with a
``None`` leaf, at ``bucket_bytes`` <= 0 (one bucket), below one leaf (a
bucket a leaf) and in between. Then two gloo workers
(``MultiWorkerMirroredStrategy(device="cpu")``) reduce and gather trees
whose values depend on the rank: ``bucketed_all_reduce`` must equal a
per-leaf ``all_reduce`` bit for bit, and ``all_gather`` (stacked and
tiled), ``host_all_reduce_sum`` and ``host_all_gather`` must give the
exact values the two ranks' inputs make. One spawn serves every
two-worker test; it has its own timeout.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models import transformer as jtr
from tpu_dist.parallel import collectives as jcoll
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.models.model import _nest
from tpu_dist_torch.parallel import collectives
from test_torch_multiworker import _run_workers
from test_torch_sync_bn import IN_SHAPE, _reference_model

BUCKET_BYTES = (-1, 0, 1, 128, 1024, 4096, 1 << 20)

WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.parallel import collectives as c

out = sys.argv[1]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
rank = td.cluster.process_index()

def tree():
    g = torch.Generator().manual_seed(rank)
    return {"w": torch.randn(7, 5, generator=g),
            "b": [torch.randn(3, generator=g).double(),
                  torch.randn(33, generator=g)],
            "z": {"k": torch.randn(2, 2, generator=g), "skip": None}}

report = {}
for op in ("mean", "sum", "max"):
    a, b = tree(), tree()
    before = c.bucketed_all_reduce.launches
    c.bucketed_all_reduce(a, op, bucket_bytes=64)
    report[op + "_launches"] = c.bucketed_all_reduce.launches - before
    for leaf in c.tree_leaves(b):
        c.all_reduce([leaf], op)
    report[op] = all(torch.equal(x, y) for x, y in
                     zip(c.tree_leaves(a), c.tree_leaves(b)))
report["buckets"] = c.partition_buckets(tree(), 64)
v = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
arrays = {"stacked": c.all_gather(v).numpy(),
          "tiled": c.all_gather({"v": v}, tiled=True)["v"].numpy(),
          "scalar": c.all_gather(torch.tensor(float(rank))).numpy(),
          "host_sum": np.asarray(c.host_all_reduce_sum(
              np.full((2, 2), rank + 1, np.int64))),
          "host_gather": c.host_all_gather(np.float32(rank + 0.5))}
np.savez(out, **arrays)
print(json.dumps({"rank": rank, **report}))
'''


def _port_lm():
    return tr.build_transformer_lm(64, 16, d_model=32, depth=2, num_heads=2)


def _trees():
    """(reference tree, port tree) pairs of the same shapes and paths."""
    from tpu_dist_torch.models import layers, resnet
    from tpu_dist_torch.models.model import Sequential

    jres = _reference_model()
    tres = Sequential(
        [*resnet._conv_bn(8, 3),
         resnet._stage(resnet._basic_block, 8, 1, 2, True),
         layers.GlobalAveragePooling2D(), layers.Dense(10)],
        input_shape=IN_SHAPE, name="narrow")
    jlm = jtr.build_transformer_lm(64, 16, d_model=32, depth=2, num_heads=2)
    mixed_j = {"a": jnp.zeros((3, 4), jnp.float32),
               "b": jnp.zeros((5,), jnp.bfloat16),
               "c": {"d": jnp.zeros((7,), jnp.int32),
                     "e": jnp.zeros((2, 2), jnp.float16), "n": None}}
    mixed_t = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16),
               "c": {"d": torch.zeros(7, dtype=torch.int32),
                     "e": torch.zeros(2, 2, dtype=torch.float16), "n": None}}
    return {
        "resnet": (jax.tree_util.tree_map(np.asarray, jres.init(0)["params"]),
                   _nest(tres.named_parameters())),
        "lm": (jax.tree_util.tree_map(np.asarray, jlm.init(0)["params"]),
               _nest(_port_lm().named_parameters())),
        "mixed": (mixed_j, mixed_t),
    }


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("name", ["resnet", "lm", "mixed"])
def test_partition_buckets_gives_the_references_index_lists(trees, name):
    jtree, ttree = trees[name]
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves = collectives.tree_leaves(ttree)
    # The same flatten order: leaf by leaf the same shapes.
    assert [tuple(np.shape(a)) for a in jleaves] == \
        [tuple(t.shape) for t in tleaves]
    for bucket_bytes in BUCKET_BYTES:
        want = jcoll.partition_buckets(jtree, bucket_bytes)
        got = collectives.partition_buckets(ttree, bucket_bytes)
        assert got == want, (name, bucket_bytes)
    assert collectives.partition_buckets(ttree, 0) == \
        [list(range(len(tleaves)))[::-1]]
    assert len(collectives.partition_buckets(ttree, 1)) == len(tleaves)


def test_partition_buckets_flushes_at_the_budget():
    tree = [torch.zeros(4), torch.zeros(4), torch.zeros(8), torch.zeros(1)]
    # Reverse order: 4 bytes, then 32 (flush at >= 32), then 16 + 16.
    assert collectives.partition_buckets(tree, 32) == [[3, 2], [1, 0]]
    assert collectives.partition_buckets({}, 32) == []


def test_one_process_collectives_are_the_identity():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    before = collectives.bucketed_all_reduce.launches
    assert collectives.bucketed_all_reduce(tree, "mean",
                                           bucket_bytes=4) is tree
    assert collectives.bucketed_all_reduce.launches == before
    g = collectives.all_gather(tree)
    assert g["a"].shape == (1, 3) and torch.equal(g["a"][0], tree["a"])
    assert collectives.all_gather(tree, tiled=True)["b"][0] is tree["b"][0]
    np.testing.assert_array_equal(collectives.host_all_gather(np.arange(3)),
                                  np.arange(3)[None])
    x = np.float32(2.5)
    assert collectives.host_all_reduce_sum(x) is x


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    outs = _run_workers(script, ["out{rank}.npz"], tmp)
    return outs, [dict(np.load(tmp / f"out{r}.npz")) for r in (0, 1)]


@pytest.mark.multiprocess
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
def test_bucketed_all_reduce_equals_per_leaf_all_reduce(two_workers, op):
    outs, _ = two_workers
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o[op] for o in outs), outs
    buckets = outs[0]["buckets"]
    # One launch per (bucket, dtype) group; MAX delegates to all_reduce.
    dtypes = {0: "f64", 1: "f32", 2: "f32", 3: "f32"}
    groups = sum(len({dtypes[i] for i in b}) for b in buckets)
    assert all(o[op + "_launches"] == (0 if op == "max" else groups)
               for o in outs)
    json.dumps(outs)


@pytest.mark.multiprocess
def test_all_gather_and_host_collectives_give_both_ranks_values(two_workers):
    _, arrays = two_workers
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    for a in arrays:   # identical on both processes
        np.testing.assert_array_equal(a["stacked"], np.stack([v, v + 10]))
        np.testing.assert_array_equal(a["tiled"], np.concatenate([v, v + 10]))
        np.testing.assert_array_equal(a["scalar"], [0.0, 1.0])
        np.testing.assert_array_equal(a["host_sum"], np.full((2, 2), 3))
        assert a["host_sum"].dtype == np.int64
        np.testing.assert_array_equal(a["host_gather"],
                                      np.float32([0.5, 1.5]))
