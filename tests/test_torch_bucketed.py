"""The bucketed gradient schedule: two gloo workers against the reference.

``compile(gradient_bucket_bytes=128)`` switches the port's multi-process
step to the reference's ``_pure_step_bucketed``: each worker's BatchNorm
takes its own shard's moments, the loss is averaged, the gradients go
through ``bucketed_all_reduce`` in 128-byte buckets, and the running state
is averaged after the step. Two workers (``MultiWorkerMirroredStrategy(
device="cpu")``, DATA sharding: 16 rows each of every global batch of 32)
fit the narrow BatchNorm net of ``test_torch_sync_bn.py`` from the
reference's ``init(0)`` for 3 steps; the reference fits the same net on
``MirroredStrategy(devices=jax.devices()[:2])`` with the same bytes. The
workers agree bit for bit; losses, parameters and running statistics
agree with the reference at atol = rtol = 1e-5 (fp32; sums in another
order). The workers also fit a net without BatchNorm under both
schedules: with two processes the sums are exact, so the bucketed fit
equals the default one bit for bit. One spawn serves every test; it has
its own timeout.
"""

import jax
import numpy as np
import pytest

from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist.parallel import strategy as jstrategy
from tpu_dist_torch.models.bridge import variables_from_jax
from test_torch_multiworker import _run_workers
from test_torch_sync_bn import BATCH, IN_SHAPE, STEPS, _reference_model

TOL = dict(atol=1e-5, rtol=1e-5)
BUCKET_BYTES = 128

WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models import layers, resnet
from tpu_dist_torch.models.model import _nest
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import collectives

weights, arrays, out = sys.argv[1:4]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
a = np.load(arrays)
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.DATA
ds = td.data.Dataset.from_tensor_slices((a["x"], a["y"])).batch(%(batch)d)
ds = ds.with_options(options)


def fit(layer_list, bucket_bytes, weights=None):
    with strategy.scope():
        model = td.models.Sequential(layer_list, input_shape=%(shape)r,
                                     name="narrow", seed=0)
        if weights is not None and td.cluster.is_chief():
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in np.load(weights).items()})
        model.compile(optimizer=optimizers.SGD(learning_rate=0.1),
                      loss=losses.SparseCategoricalCrossentropy(
                          from_logits=True),
                      gradient_bucket_bytes=bucket_bytes)
    before = collectives.bucketed_all_reduce.launches
    history = model.fit(ds, epochs=1, steps_per_epoch=%(steps)d,
                        verbose=0).history
    buckets = len(collectives.partition_buckets(
        _nest(model.named_parameters()), bucket_bytes))
    return model, history["loss"], {
        "launches": collectives.bucketed_all_reduce.launches - before,
        "buckets": buckets,
        "synced": [m.synchronized for m in model.modules()
                   if isinstance(m, layers.BatchNormalization)]}


bn, bn_loss, bn_info = fit(
    [*resnet._conv_bn(8, 3),
     resnet._stage(resnet._basic_block, 8, 1, 2, True),
     layers.GlobalAveragePooling2D(), layers.Dense(10)], %(bytes)d, weights)
plain = lambda: [layers.Conv2D(8, 3, activation="relu"),
                 layers.GlobalAveragePooling2D(), layers.Dense(10)]
bucketed, b_loss, b_info = fit(plain(), %(bytes)d)
default, d_loss, _ = fit(plain(), 0)
np.savez(out, **{k: v.numpy() for k, v in bn.state_dict().items()})
same = all(torch.equal(p, q) for p, q in zip(bucketed.parameters(),
                                             default.parameters()))
print(json.dumps({"rank": td.cluster.process_index(), "loss": bn_loss,
                  **bn_info, "plain_buckets": b_info["buckets"],
                  "plain_launches": b_info["launches"],
                  "plain_equal": same and b_loss == d_loss}))
''' % {"batch": BATCH, "shape": IN_SHAPE, "steps": STEPS,
       "bytes": BUCKET_BYTES}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bucketed")
    jm = _reference_model()
    init = jax.tree_util.tree_map(np.asarray, jm.init(0))
    np.savez(tmp / "init.npz",
             **{k: v.numpy() for k, v in variables_from_jax(init).items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((STEPS * BATCH, *IN_SHAPE)).astype(np.float32)
    y = rng.integers(0, 10, STEPS * BATCH)
    np.savez(tmp / "arrays.npz", x=x, y=y)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    outs = _run_workers(script, ["init.npz", "arrays.npz", "state{rank}.npz"],
                        tmp)
    states = [dict(np.load(tmp / f"state{r}.npz")) for r in (0, 1)]
    with jstrategy.MirroredStrategy(devices=jax.devices()[:2]).scope():
        jm.compile(optimizer=jopt.SGD(learning_rate=0.1),
                   loss=jlosses.SparseCategoricalCrossentropy(
                       from_logits=True),
                   gradient_bucket_bytes=BUCKET_BYTES)
    history = jm.fit((x, y), epochs=1, steps_per_epoch=STEPS,
                     verbose=0).history
    want = variables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jm.variables))
    return outs, states, [float(v) for v in history["loss"]], want


@pytest.mark.multiprocess
def test_workers_agree_bit_for_bit_with_local_moments(run):
    outs, states, _, _ = run
    assert [o["rank"] for o in outs] == [0, 1]
    # The bucketed schedule takes each shard's own moments.
    assert all(o["synced"] == [False] * 4 for o in outs), outs
    assert outs[0]["loss"] == outs[1]["loss"]
    for name in states[0]:
        np.testing.assert_array_equal(states[0][name], states[1][name],
                                      err_msg=name)


@pytest.mark.multiprocess
def test_bucketed_fit_matches_the_references_bucketed_fit(run):
    outs, states, jloss, want = run
    np.testing.assert_allclose(outs[0]["loss"], jloss, **TOL)
    assert sorted(states[0]) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(states[0][name], value.numpy(),
                                   err_msg=name, **TOL)
    moved = [n for n in want if n.endswith(".var")
             and not np.allclose(states[0][n], 1.0)]
    assert moved, "no BatchNorm running variance moved"


@pytest.mark.multiprocess
def test_every_step_launches_one_collective_a_bucket(run):
    outs, _, _, _ = run
    for o in outs:
        assert o["buckets"] > 1 and o["launches"] == o["buckets"] * STEPS
        assert o["plain_launches"] == o["plain_buckets"] * STEPS


@pytest.mark.multiprocess
def test_without_batchnorm_the_bucketed_fit_equals_the_default(run):
    outs, _, _, _ = run
    assert all(o["plain_equal"] for o in outs), outs
