"""Sync-BN: two gloo workers fit a narrow BatchNorm residual net.

The reference's default step is one ``jit`` over the globally sharded
batch, so its BatchNorm moments are the global batch's. The port's
trainer in a process group sets every BatchNorm ``synchronized``: the
forward all-reduces ``[Σx, n]`` and then the centred ``Σ(x − mean)²`` per
channel, and the backward ``[Σdy, Σdy·x̂]``. Two workers (``MultiWorkerMirroredStrategy(device=
"cpu")``, DATA sharding: each takes half of every global batch of 32)
start from the reference's ``init(0)`` variables and fit 3 steps. They
must agree with each other bit for bit (losses, parameters, running
statistics) and with the reference's single-process ``fit`` on the same
global batches at atol = rtol = 1e-5 (fp32; the moments sum in another
order). ``test_torch_faults.py`` holds the variance on off-centre data.
Each run has its own timeout.
"""

import json

import jax
import numpy as np
import pytest

from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.models import resnet as jresnet
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.models.bridge import variables_from_jax
from test_torch_multiworker import _run_workers

TOL = dict(atol=1e-5, rtol=1e-5)
IN_SHAPE = (8, 8, 3)
STEPS, BATCH = 3, 32

WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models import layers, resnet
from tpu_dist_torch.ops import losses, optimizers

weights, arrays, out = sys.argv[1:4]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
assert strategy.num_replicas_in_sync == 2
a = np.load(arrays)
ds = td.data.Dataset.from_tensor_slices((a["x"], a["y"])).batch(%d)
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.DATA
with strategy.scope():
    model = td.models.Sequential(
        [*resnet._conv_bn(8, 3),
         resnet._stage(resnet._basic_block, 8, 1, 2, True),
         layers.GlobalAveragePooling2D(), layers.Dense(10)],
        input_shape=%r, name="narrow", seed=td.cluster.process_index())
    if td.cluster.is_chief():
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in np.load(weights).items()})
    model.compile(optimizer=optimizers.SGD(learning_rate=0.1),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True))
history = model.fit(ds.with_options(options), epochs=1, steps_per_epoch=%d,
                    verbose=0).history
synced = [m.synchronized for m in model.modules()
          if isinstance(m, layers.BatchNormalization)]
np.savez(out, **{k: v.numpy() for k, v in model.state_dict().items()})
print(json.dumps({"rank": td.cluster.process_index(), "loss": history["loss"],
                  "synced": synced}))
''' % (BATCH, IN_SHAPE, STEPS)


def _reference_model():
    return jmodel_lib.Sequential(
        [*jresnet._conv_bn(8, 3),
         jresnet._stage(jresnet._basic_block, 8, 1, 2, True),
         jlayers.GlobalAveragePooling2D(), jlayers.Dense(10)],
        input_shape=IN_SHAPE, name="narrow")


@pytest.mark.multiprocess
def test_two_gloo_workers_with_sync_bn_match_the_reference(tmp_path):
    jm = _reference_model()
    init = jax.tree_util.tree_map(np.asarray, jm.init(0))
    np.savez(tmp_path / "init.npz",
             **{k: v.numpy() for k, v in variables_from_jax(init).items()})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((STEPS * BATCH, *IN_SHAPE)).astype(np.float32)
    y = rng.integers(0, 10, STEPS * BATCH)
    np.savez(tmp_path / "arrays.npz", x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = _run_workers(script, ["init.npz", "arrays.npz",
                                 "state{rank}.npz"], tmp_path)
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["synced"] == [True] * 4 for o in outs), outs
    assert outs[0]["loss"] == outs[1]["loss"]
    states = [dict(np.load(tmp_path / f"state{r}.npz")) for r in (0, 1)]
    assert sorted(states[0]) == sorted(variables_from_jax(init))
    for name in states[0]:
        np.testing.assert_array_equal(states[0][name], states[1][name],
                                      err_msg=name)
    jm.compile(optimizer=jopt.SGD(learning_rate=0.1),
               loss=jlosses.SparseCategoricalCrossentropy(from_logits=True))
    history = jm.fit((x, y), epochs=1, steps_per_epoch=STEPS,
                     verbose=0).history
    np.testing.assert_allclose(outs[0]["loss"],
                               [float(v) for v in history["loss"]], **TOL)
    want = variables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jm.variables))
    for name, value in want.items():
        np.testing.assert_allclose(states[0][name], value.numpy(),
                                   err_msg=name, **TOL)
    # The running statistics moved: the step updated them in place.
    moved = [n for n in want if n.endswith(".mean")
             and np.abs(states[0][n]).max() > 0]
    assert moved, "no BatchNorm running mean moved"
    json.dumps(outs)  # the workers' reports are plain JSON
