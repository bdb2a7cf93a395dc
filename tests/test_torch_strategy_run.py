"""The custom-loop surface of the strategies against the reference's.

``InputContext`` and ``distribute_datasets_from_function`` in one process
against the reference's on one device (the same context, the same
batches). Two gloo workers (``MultiWorkerMirroredStrategy(device="cpu")``)
then take their rows of a global batch of 16 (``shard_batch``) and call
``strategy.run`` on the reference MNIST CNN at the reference's ``init(0)``
weights: the stacked per-replica results and ``reduce("mean")`` equal the
reference's ``run`` + ``reduce`` on a 2-device mesh at 1e-5, identical on
both workers. Last, the port's ``examples/custom_training_loop.py`` runs
3 steps, in this process and as the two workers; the reference's loop
(its example's jitted step, from the port's ``init(0)`` weights) on the
same global batches, each worker's pipeline seeded by its id and the two
halves side by side, gives the same losses, per-replica losses and
parameters at 1e-5. One spawn serves every two-worker test; it has its own
timeout.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tpu_dist import data as jdata
from tpu_dist.models import cnn as jcnn
from tpu_dist.ops import optimizers as jopt
from tpu_dist.ops.losses import sparse_categorical_crossentropy as jsce
from tpu_dist.parallel import strategy as jstrategy
from tpu_dist_torch import data
from tpu_dist_torch.examples import custom_training_loop
from tpu_dist_torch.models.bridge import variables_from_jax
from tpu_dist_torch.models.cnn import build_cnn_model
from tpu_dist_torch.parallel import InputContext, MirroredStrategy
from test_torch_multiworker import _run_workers

TOL = dict(atol=1e-5, rtol=1e-5)
LOOP_STEPS = 3

WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.examples import custom_training_loop
from tpu_dist_torch.models.model import _nest
from tpu_dist_torch.ops.losses import sparse_categorical_crossentropy

weights, batch, out = sys.argv[1:4]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
model = td.models.build_cnn_model()
params = strategy.replicate(_nest(
    (k, torch.from_numpy(v)) for k, v in np.load(weights).items()))
b = np.load(batch)
x, y = td.parallel.shard_batch((b["x"], b["y"]), strategy.mesh)

def stats(params, x, y):
    logits, _ = model.apply(params, {}, x)
    return {"loss": sparse_categorical_crossentropy(logits, y).mean(),
            "rows": len(y)}

per_replica = strategy.run(stats, args=(params, x, y))
mean = strategy.reduce("mean", per_replica)
loop = custom_training_loop.main(["--device", "cpu", "--steps", "%d"])
np.savez(out, **loop.pop("params"))
print(json.dumps({
    "rank": td.cluster.process_index(), "rows": len(y),
    "per_replica": {k: v.tolist() for k, v in per_replica.items()},
    "mean": {k: float(v) for k, v in mean.items()}, "loop": loop}))
''' % LOOP_STEPS


def _reference_params(seed: int = 0):
    return jax.tree_util.tree_map(np.asarray, jcnn.build_cnn_model().init(
        seed)["params"])


def _dataset_fn(pkg, ctx, global_batch):
    ds = pkg.load("mnist", split="train", synthetic_size=4096)
    ds = ds.map(lambda x, y: (np.asarray(x, np.float32) / 255.0, y))
    return ds.shuffle(1024, seed=ctx.input_pipeline_id).batch(
        ctx.get_per_replica_batch_size(global_batch)).repeat()


def test_input_context_matches_the_references():
    for args in ((1, 0, 1), (2, 1, 2), (4, 3, 8)):
        ours, theirs = InputContext(*args), jstrategy.InputContext(*args)
        assert repr(ours) == repr(theirs)
        assert (ours.get_per_replica_batch_size(64)
                == theirs.get_per_replica_batch_size(64))
    with pytest.raises(ValueError, match="not divisible"):
        InputContext(2, 0, 3).get_per_replica_batch_size(64)


def test_distribute_datasets_from_function_matches_the_reference():
    seen = []

    def port_fn(ctx):
        seen.append((ctx.num_input_pipelines, ctx.input_pipeline_id,
                     ctx.num_replicas_in_sync))
        return _dataset_fn(data, ctx, 8)

    strategy = MirroredStrategy(device="cpu")
    ours = strategy.experimental_distribute_datasets_from_function(port_fn)
    ref = jstrategy.MirroredStrategy(devices=jax.devices()[:1])
    theirs = ref.distribute_datasets_from_function(
        lambda ctx: _dataset_fn(jdata, ctx, 8))
    assert seen == [(1, 0, 1)] and strategy.input_shard_info() == (1, 0)
    for (x, y), (jx, jy) in zip(ours, theirs):
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
        placed = strategy.distribute_batch((x, y))
        assert all(isinstance(t, torch.Tensor) for t in placed)
        break


def test_run_and_reduce_in_one_process_stack_one_replica():
    strategy = MirroredStrategy(device="cpu")
    params = strategy.replicate({"w": np.ones((2, 3), np.float32)})
    out = strategy.run(lambda p, s: {"sum": p["w"].sum() * s, "n": 3},
                       args=(params, 2.0))
    assert out["sum"].shape == (1,) and float(out["sum"][0]) == 12.0
    assert float(strategy.reduce("mean", out)["sum"]) == 12.0
    assert out["n"].tolist() == [3]


def _reference_loop(params, pipelines: int, steps: int):
    """The reference example's jitted step on the global batches of
    ``pipelines`` workers (each pipeline seeded by its id, per-replica
    batch 8, the halves side by side); per-replica losses after step 0."""
    model = jcnn.build_cnn_model()
    opt = jopt.SGD(learning_rate=0.01)
    opt_state = opt.init(params)
    streams = [iter(_dataset_fn(jdata, InputContext(pipelines, i, pipelines),
                                8 * pipelines)) for i in range(pipelines)]

    @jax.jit
    def train_step(params, opt_state, x, y):
        def loss_fn(p):
            logits, _ = model.apply(p, {}, x, training=True)
            return jsce(logits, y, from_logits=True).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return loss, new_params, new_opt

    def replica_loss(params, x, y):
        logits, _ = model.apply(params, {}, x, training=False)
        return float(jsce(logits, y, from_logits=True).mean())

    losses, per_replica = [], None
    for step in range(steps):
        halves = [next(s) for s in streams]
        x = np.concatenate([h[0] for h in halves])
        y = np.concatenate([h[1] for h in halves])
        loss, params, opt_state = train_step(params, opt_state, x, y)
        losses.append(float(loss))
        if step == 0:
            per_replica = [replica_loss(params, hx, hy) for hx, hy in halves]
    return losses, per_replica, params


def _port_init_as_reference():
    """The port's ``init(0)`` CNN parameters (the example's start) as the
    reference's params tree."""
    tree = build_cnn_model().init(seed=0)["params"]
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


def _assert_loop_matches(loop, pipelines):
    losses, per_replica, params = _reference_loop(
        _port_init_as_reference(), pipelines, LOOP_STEPS)
    np.testing.assert_allclose(loop["losses"], losses, **TOL)
    np.testing.assert_allclose(loop["per_replica"]["0"], per_replica, **TOL)
    np.testing.assert_allclose(loop["mean_of_replicas"]["0"],
                               np.mean(per_replica), **TOL)
    return params


def test_custom_training_loop_in_one_process_matches_the_references():
    loop = custom_training_loop.main(["--device", "cpu", "--steps",
                                      str(LOOP_STEPS)])
    loop = json.loads(json.dumps({k: v for k, v in loop.items()
                                  if k != "params"})) | {
        "params": loop["params"]}
    params = _assert_loop_matches(loop, 1)
    want = {k: v.numpy() for k, v in variables_from_jax(
        {"params": params}).items()}
    assert sorted(loop["params"]) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(loop["params"][name], value,
                                   err_msg=name, **TOL)


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("strategy_run")
    params = _reference_params()
    np.savez(tmp / "weights.npz",
             **{k: v.numpy() for k, v in variables_from_jax(
                 {"params": params}).items()})
    rng = np.random.default_rng(2)
    x = rng.random((16, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 16)
    np.savez(tmp / "batch.npz", x=x, y=y)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    outs = _run_workers(script, ["weights.npz", "batch.npz",
                                 "params{rank}.npz"], tmp)
    loops = [dict(np.load(tmp / f"params{r}.npz")) for r in (0, 1)]
    return outs, loops, params, (x, y)


@pytest.mark.multiprocess
def test_run_and_reduce_on_two_workers_match_the_references_mesh(two_workers):
    outs, _, params, (x, y) = two_workers
    assert [o["rank"] for o in outs] == [0, 1]
    assert [o["rows"] for o in outs] == [8, 8]
    assert outs[0]["per_replica"] == outs[1]["per_replica"]
    model = jcnn.build_cnn_model()
    ref = jstrategy.MirroredStrategy(devices=jax.devices()[:2])

    def stats(params, x, y):
        logits, _ = model.apply(params, {}, x)
        return {"loss": jsce(logits, y).mean(), "rows": y.shape[0]}

    xs, ys = ref.distribute_batch((x, y))
    want = ref.run(stats, args=(ref.replicate(params), xs, ys))
    mean = ref.reduce("mean", want)
    for o in outs:
        np.testing.assert_allclose(o["per_replica"]["loss"],
                                   np.asarray(want["loss"]), **TOL)
        assert o["per_replica"]["rows"] == [8, 8]
        np.testing.assert_allclose(o["mean"]["loss"],
                                   float(mean["loss"]), **TOL)


@pytest.mark.multiprocess
def test_custom_training_loop_on_two_workers_matches_the_references(
        two_workers):
    outs, loops, _, _ = two_workers
    a, b = (o["loop"] for o in outs)
    assert a["losses"] == b["losses"]
    assert a["per_replica"] == b["per_replica"]
    for name in loops[0]:
        np.testing.assert_array_equal(loops[0][name], loops[1][name],
                                      err_msg=name)
    params = _assert_loop_matches(a, 2)
    want = {k: v.numpy() for k, v in variables_from_jax(
        {"params": params}).items()}
    for name, value in want.items():
        np.testing.assert_allclose(loops[0][name], value, err_msg=name,
                                   **TOL)
