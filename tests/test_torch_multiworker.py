"""Two real worker processes training the port's CNN over gloo on the CPU.

Each worker gets its TF_CONFIG from ``make_local_cluster``, builds
``MultiWorkerMirroredStrategy(device="cpu")`` (a gloo process group), and
runs ``fit`` on the reference program's chain from the same starting
weights (the reference's ``init(0)``, saved by the test). Every step
all-reduces the gradients and the loss, so both workers must report the
same per-epoch History, bit for bit, and end with the same parameters.
Against the reference: its single-process ``fit`` on the global batches
(OFF: the two workers' identical seeded 32-row batches side by side;
DATA: the 64-row batches the two workers split) gives the same losses and
parameters at atol 1e-5 (fp32, sums in another order). The reference
program itself also runs as two workers. Each run has its own timeout, so
a hang fails the test instead of stalling the suite.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_dist.data import pipeline as jpipeline
from tpu_dist.models import cnn as jcnn
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch import data
from tpu_dist_torch.cluster import make_local_cluster
from tpu_dist_torch.models.bridge import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
TOL = dict(atol=1e-5, rtol=1e-5)
EPOCHS, STEPS = 2, 3

WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.ops import losses, metrics, optimizers

policy, weights, out = sys.argv[1:4]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
assert strategy.num_replicas_in_sync == 2

def scale(image, label):
    return np.asarray(image, np.float32) / 255.0, label

ds = (td.data.load("mnist", split="train", synthetic_size=512)
      .map(scale).cache().shuffle(1000, seed=3)
      .batch(32 if policy == "OFF" else 64))
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy[policy]
with strategy.scope():
    model = td.models.build_cnn_model(seed=td.cluster.process_index())
    if td.cluster.is_chief():
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in np.load(weights).items()})
    model.compile(optimizer=optimizers.SGD(learning_rate=0.05),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                  metrics=[metrics.SparseCategoricalAccuracy()])
history = model.fit(ds.with_options(options), epochs=%d, steps_per_epoch=%d,
                    verbose=0).history
np.savez(out, **{k: v.numpy() for k, v in model.state_dict().items()})
print(json.dumps({"rank": td.cluster.process_index(), "loss": history["loss"],
                  "accuracy": history["accuracy"]}))
''' % (EPOCHS, STEPS)

EXAMPLE = '''
import json, runpy, sys
sys.argv = ["tpu_dist_example", "--device", "cpu"]
g = runpy.run_module("tpu_dist_torch.examples.tpu_dist_example",
                     run_name="__main__")
print(json.dumps(g["history"].history))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(script: Path, args, tmp_path: Path) -> list[dict]:
    """Both workers to their end (or the timeout); their last output lines
    as JSON, in rank order."""
    procs = []
    for rank, tf_config in enumerate(make_local_cluster(
            2, base_port=_free_port())):
        env = dict(os.environ, TF_CONFIG=json.dumps(tf_config),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *[a.format(rank=rank)
                                            for a in args]],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _reference_fit(x, y, global_batch):
    jmodel = jcnn.build_cnn_model()
    jmodel.compile(optimizer=jopt.SGD(learning_rate=0.05),
                   loss=jlosses.SparseCategoricalCrossentropy(
                       from_logits=True),
                   metrics=[jmetrics.SparseCategoricalAccuracy()])
    ds = jpipeline.Dataset.from_tensor_slices((x, y)).batch(global_batch)
    history = jmodel.fit(ds, epochs=EPOCHS, steps_per_epoch=STEPS,
                         verbose=0).history
    return history, params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.variables["params"]))


def _global_batches(policy):
    """The global batches of the run, from the (reference-identical) chain:
    OFF doubles each worker's identical 32-row batch, DATA keeps 64 rows."""
    ds = (data.load("mnist", split="train", synthetic_size=512)
          .map(lambda i, l: (np.asarray(i, np.float32) / 255.0, l))
          .cache().shuffle(1000, seed=3)
          .batch(32 if policy == "OFF" else 64))
    batches = list(ds)[:EPOCHS * STEPS]
    if policy == "OFF":
        batches = [(np.concatenate([bx, bx]), np.concatenate([by, by]))
                   for bx, by in batches]
    return (np.concatenate([bx for bx, _ in batches]),
            np.concatenate([by for _, by in batches]))


@pytest.mark.multiprocess
@pytest.mark.parametrize("policy", ["OFF", "DATA"])
def test_two_gloo_workers_agree_with_each_other_and_the_reference(
        policy, tmp_path):
    init = jax.tree_util.tree_map(
        np.asarray, jcnn.build_cnn_model().init(0)["params"])
    weights = tmp_path / "init.npz"
    np.savez(weights, **{k: v.numpy()
                         for k, v in params_from_jax(init).items()})
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = _run_workers(script, [policy, str(weights), "params{rank}.npz"],
                        tmp_path)
    assert [o["rank"] for o in outs] == [0, 1]
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["accuracy"] == outs[1]["accuracy"]
    params = [dict(np.load(tmp_path / f"params{r}.npz")) for r in (0, 1)]
    for name in params[0]:
        np.testing.assert_array_equal(params[0][name], params[1][name],
                                      err_msg=name)
    history, want = _reference_fit(*_global_batches(policy), 64)
    np.testing.assert_allclose(outs[0]["loss"],
                               [float(v) for v in history["loss"]], **TOL)
    np.testing.assert_allclose(outs[0]["accuracy"],
                               [float(v) for v in history["accuracy"]],
                               **TOL)
    for name, value in want.items():
        np.testing.assert_allclose(params[0][name], value.numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.multiprocess
def test_reference_program_runs_as_two_gloo_workers(tmp_path):
    script = tmp_path / "example.py"
    script.write_text(EXAMPLE)
    outs = _run_workers(script, [], tmp_path)
    # Unseeded OFF shuffles: each worker trains on its own order, and the
    # all-reduced steps keep the two in lockstep.
    for key in ("loss", "accuracy"):
        assert outs[0][key] == outs[1][key], key
    assert len(outs[0]["loss"]) == 10
    assert outs[0]["loss"][-1] < outs[0]["loss"][0]
