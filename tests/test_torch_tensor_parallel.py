"""Tensor parallelism (a ``model`` mesh axis): gloo workers against the
reference.

The bar is the reference's (``tests/test_tensor_parallel.py``): a model
axis changes placement only. The port's rules give the reference's spec
for every leaf (the optimizer states too). Two spawns serve every fit, each
with its own timeout:

* two workers, ``MultiWorkerMirroredStrategy(axis_shapes={"data": 1,
  "model": 2})``, and four, ``{"data": 2, "model": 2}``, fit the LM from
  the reference's ``init(0)`` (bridged weights) with Adam. Losses,
  predictions and the gathered parameters equal the reference's fit on
  the same mesh (``MirroredStrategy(devices=jax.devices()[:n],
  axis_shapes=...)``) at atol = rtol = 2e-5, the reference's own bar. The
  key projection's bias ``bk`` is the exception among the parameters: its
  gradient is zero in exact arithmetic (softmax cancels a constant per
  query row), so Adam takes its rounding noise to full-size steps and its
  value is that noise in both packages; it is held to the sum of the
  steps' sizes instead (lr x steps).
* each process holds the block of each sharded leaf that the spec names;
  replicated leaves (and their Adam moments) are bit-equal across the
  model axis;
* a model axis over the CNN (its Dense pair shards) trains as one process
  does; the ``mixed_bfloat16`` policy composes (parameters stay fp32 and
  sharded);
* checkpoints restore across topologies (the reference's
  ``TestCrossTopologyRestore``): ``{data: 2, model: 2}`` to ``{data: 4}``,
  one process to ``{model: 2}``, ``{model: 2}`` to one process; each
  continued fit equals the uninterrupted one;
* ``examples/tensor_parallel_lm.py`` runs on the two workers at a tiny
  size.
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
import torch

import tpu_dist as tdj
from tpu_dist.models.transformer import build_transformer_lm as jlm
from tpu_dist.parallel import tensor as jtensor
from tpu_dist_torch.cluster import make_local_cluster
from tpu_dist_torch.models.bridge import params_from_jax, variables_from_jax
from tpu_dist_torch.models.cnn import build_cnn_model
from tpu_dist_torch.models.model import _nest
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.ops.optimizers import AdamState
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel import tensor

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 150
TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB, SEQ, LR = 29, 16, 1e-2
EPOCHS, STEPS = 2, 4
AXES = {2: {"data": 1, "model": 2}, 4: {"data": 2, "model": 2}}

COMMON = '''
import json, os, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.models.policy import set_policy
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import tensor
from tpu_dist_torch.training import checkpoint

VOCAB, SEQ, LR = %(vocab)d, %(seq)d, %(lr)r
seq = np.arange(256) * 3 %% VOCAB
XS = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)]).astype(np.int64)
YS = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)]).astype(
    np.int64)


def dataset():
    return td.data.Dataset.from_tensor_slices((XS, YS)).batch(16).repeat()


def lm(strategy, weights=None, metrics=()):
    with strategy.scope():
        model = build_transformer_lm(
            VOCAB, SEQ, d_model=32, depth=1, num_heads=4,
            seed=td.cluster.process_index())
        if weights is not None and td.cluster.is_chief():
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in np.load(weights).items()})
        model.compile(loss=losses.SparseCategoricalCrossentropy(
            from_logits=True), optimizer=optimizers.Adam(LR),
            metrics=list(metrics), device="cpu")
    return model


def fit(model, steps, epochs=1):
    return model.fit(dataset(), epochs=epochs, steps_per_epoch=steps,
                     verbose=0).history["loss"]


def save(path, **arrays):
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def main_fit(strategy, tag):
    model = lm(strategy, "init.npz", ["accuracy"])
    loss = fit(model, %(steps)d, %(epochs)d)
    preds = model.predict(XS[:4])
    full = {"p/" + k: v.numpy() for k, v in tensor.gather_params(model).items()}
    local = {"l/" + k: p.detach().numpy() for k, p in model.named_parameters()}
    opt = model._trainer.variables["opt"]
    names = [n for n, _ in model.named_parameters()]
    local.update(("mu/" + n, t.numpy()) for n, t in zip(names, opt.mu))
    save(f"{tag}{td.cluster.process_index()}.npz", preds=preds, **full,
         **local)
    return loss
''' % {"vocab": VOCAB, "seq": SEQ, "lr": LR, "steps": STEPS,
       "epochs": EPOCHS}

WORKER2 = COMMON + '''
strategy = td.MultiWorkerMirroredStrategy(
    axis_shapes={"data": 1, "model": 2}, device="cpu")
out = {"rank": td.cluster.process_index(),
       "replicas": strategy.num_replicas_in_sync,
       "loss": main_fit(strategy, "tp2_")}

# One process's checkpoint (written by the test) onto {model: 2}.
reader = lm(strategy)
out["from_single_step"] = checkpoint.restore_model("single_ckpt", reader)
out["from_single_post"] = fit(reader, 3)

# {model: 2}'s checkpoint for the test to restore in one process.
writer = lm(strategy, "init.npz")
fit(writer, 2)
checkpoint.save("tp2_ckpt", writer, step=2)
out["tp2_post"] = fit(writer, 3)

# Heads the axis does not divide: the attention stays whole, the MLP and
# the head shard (the test fits the same LM in one process).
with strategy.scope():
    odd = build_transformer_lm(VOCAB, SEQ, d_model=30, depth=1,
                               num_heads=3)
    odd.compile(loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                optimizer=optimizers.Adam(LR), device="cpu")
out["odd_heads_loss"] = fit(odd, 3)
out["odd_heads_layout"] = sorted(odd._tensor_parallel[1])

# A model axis over the CNN (the test fits it in one process).
with strategy.scope():
    cnn = td.models.build_cnn_model()
    cnn.compile(optimizer=optimizers.SGD(learning_rate=0.05),
                loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                device="cpu")
rng = np.random.default_rng(0)
x = rng.normal(size=(64, 28, 28, 1)).astype(np.float32)
y = rng.integers(0, 10, size=(64,)).astype(np.int64)
out["cnn_loss"] = cnn.fit(td.data.Dataset.from_tensor_slices((x, y)).batch(
    32).repeat(), epochs=1, steps_per_epoch=3, verbose=0).history["loss"]
out["cnn_layout"] = sorted(cnn._tensor_parallel[1])

# The mixed policy on the sharded model.
set_policy("mixed_bfloat16")
try:
    mixed = lm(strategy, metrics=["accuracy"])
    out["bf16_loss"] = fit(mixed, 3)
    out["bf16_eval"] = float(mixed.evaluate(dataset(), steps=2,
                                            verbose=0)["loss"])
    wq = dict(mixed.named_parameters())[
        "block.residual.main.multiheadattention.wq"]
    out["bf16_wq"] = [str(wq.dtype), list(wq.shape)]
finally:
    set_policy("float32")

from tpu_dist_torch.examples import tensor_parallel_lm

out["example"] = tensor_parallel_lm.main(
    ["--device", "cpu", "--vocab", "64", "--seq-len", "16", "--d-model",
     "32", "--epochs", "1", "--steps", "2"])
print(json.dumps(out))
'''

WORKER4 = COMMON + '''
strategy = td.MultiWorkerMirroredStrategy(
    axis_shapes={"data": 2, "model": 2}, device="cpu")
out = {"rank": td.cluster.process_index(),
       "replicas": strategy.num_replicas_in_sync,
       "loss": main_fit(strategy, "tp4_")}

# {data: 2, model: 2} -> {data: 4}: write at step 2, go on for 3 steps.
writer = lm(strategy, "init.npz")
fit(writer, 2)
checkpoint.save("tp4_ckpt", writer, step=2)
out["ref_post"] = fit(writer, 3)
data4 = td.MultiWorkerMirroredStrategy(axis_shapes={"data": 4},
                                       device="cpu")
reader = lm(data4)
out["data4_step"] = checkpoint.restore_model("tp4_ckpt", reader)
out["data4_post"] = fit(reader, 3)
print(json.dumps(out))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, script: Path, tmp: Path) -> list:
    """``n`` workers of ``script`` started in ``tmp``."""
    procs = []
    for tf_config in make_local_cluster(n, base_port=_free_port()):
        env = dict(os.environ, TF_CONFIG=json.dumps(tf_config),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs: list) -> list:
    """Every worker to its end (or the timeout); their last output lines
    as JSON, in rank order."""
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


def _dataset():
    seq = np.arange(256) * 3 % VOCAB
    xs = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)])
    ys = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)])
    return xs.astype(np.int64), ys.astype(np.int64)


def _reference_fit(axis_shapes) -> dict:
    """The reference's fit on a mesh of ``prod(axis_shapes)`` devices."""
    n = int(np.prod(list(axis_shapes.values())))
    xs, ys = _dataset()
    strategy = tdj.MirroredStrategy(devices=jax.devices()[:n],
                                    axis_shapes=axis_shapes)
    with strategy.scope():
        model = jlm(VOCAB, SEQ, d_model=32, depth=1, num_heads=4)
        model.compile(loss=tdj.ops.SparseCategoricalCrossentropy(
            from_logits=True), optimizer=tdj.ops.Adam(LR),
            metrics=["accuracy"])
        ds = tdj.data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
        hist = model.fit(ds, epochs=EPOCHS, steps_per_epoch=STEPS, verbose=0)
        preds = np.asarray(model.predict(xs[:4]))
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, model.variables["params"]))
    return {"loss": hist.history["loss"], "preds": preds, "params": params}


def _cnn_data():
    from tpu_dist_torch import data

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(64,)).astype(np.int64)
    return data.Dataset.from_tensor_slices((x, y)).batch(32).repeat()


def _port_lm(seed: int = 0):
    model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                 num_heads=4, seed=seed)
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    return model


def _port_fit(model, steps: int) -> list:
    from tpu_dist_torch import data

    xs, ys = _dataset()
    ds = data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
    return model.fit(ds, epochs=1, steps_per_epoch=steps,
                     verbose=0).history["loss"]


@pytest.fixture(scope="module")
def run(eight_devices, tmp_path_factory):
    from tpu_dist_torch.training import checkpoint

    tmp = tmp_path_factory.mktemp("tensor_parallel")
    init = jax.tree_util.tree_map(
        np.asarray, jlm(VOCAB, SEQ, d_model=32, depth=1, num_heads=4).init(0))
    weights = {k: v.numpy() for k, v in variables_from_jax(init).items()}
    np.savez(tmp / "init.npz", **weights)
    # One process's checkpoint at step 2 and its uninterrupted 3 steps.
    single = _port_lm()
    single.load_state_dict({k: torch.from_numpy(v) for k, v in
                            weights.items()})
    _port_fit(single, 2)
    checkpoint.save(tmp / "single_ckpt", single, step=2)
    single_post = _port_fit(single, 3)
    cnn = build_cnn_model()
    cnn.compile(optimizer=optimizers.SGD(learning_rate=0.05),
                loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                device="cpu")
    cnn_loss = cnn.fit(_cnn_data(), epochs=1, steps_per_epoch=3,
                       verbose=0).history["loss"]
    odd = build_transformer_lm(VOCAB, SEQ, d_model=30, depth=1, num_heads=3)
    odd.compile(loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                optimizer=optimizers.Adam(LR), device="cpu")
    odd_loss = _port_fit(odd, 3)
    procs = {}
    for n, text in ((2, WORKER2), (4, WORKER4)):
        (tmp / f"worker{n}.py").write_text(text)
        procs[n] = _spawn(n, tmp / f"worker{n}.py", tmp)
    # The reference fits while the workers run.
    refs = {n: _reference_fit(axes) for n, axes in AXES.items()}
    outs = {n: _finish(p) for n, p in procs.items()}
    # {model: 2}'s checkpoint restored in one process.
    reader = _port_lm(seed=5)
    restored = (checkpoint.restore_model(tmp / "tp2_ckpt", reader),
                _port_fit(reader, 3))
    arrays = {n: [dict(np.load(tmp / f"tp{n}_{r}.npz")) for r in range(n)]
              for n in AXES}
    return {"outs": outs, "refs": refs, "arrays": arrays,
            "single_post": single_post, "restored": restored,
            "cnn_loss": cnn_loss, "odd_heads_loss": odd_loss}


# -- the rules ---------------------------------------------------------------------

def _flat(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


def test_spec_rules_equal_the_references_leaf_by_leaf():
    jparams = jlm(VOCAB, SEQ, d_model=32, depth=1, num_heads=4).init(0)[
        "params"]
    model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                 num_heads=4)
    got = _flat(tensor.tensor_parallel_specs(
        _nest(model.named_parameters())))
    want = _flat(jtensor.tensor_parallel_specs(jparams))
    assert got == want
    assert got["block.residual.main.multiheadattention.wq"] == (None,
                                                                "model")
    assert got["block.residual_1.main.dense_1.kernel"] == ("model", None)
    assert got["embedding.table"] == ()
    # The pruned specs on a {data: 1, model: 2} mesh: the vocab head (29
    # columns) goes replicated in both.
    mesh = mesh_lib.Mesh(("data", "model"), (1, 2), torch.device("cpu"))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                              ("data", "model"))
    tree = _nest(model.named_parameters())
    pruned = _flat(tensor.prune_indivisible(
        tensor.tensor_parallel_specs(tree), tree, mesh))
    assert pruned == _flat(jtensor.prune_indivisible(
        jtensor.tensor_parallel_specs(jparams), jparams, jmesh))
    assert pruned["dense.kernel"] == ()


def test_dense_roles_follow_structural_position():
    # An extra Dense ahead of a block shifts the uniquing counter; roles
    # come from position within the owning chain (the reference's case).
    z = lambda *s: np.zeros(s, np.float32)
    params = {
        "dense": {"kernel": z(8, 16), "bias": z(16)},
        "block": {"residual_1": {"main": {
            "dense_1": {"kernel": z(16, 64), "bias": z(64)},
            "dense_2": {"kernel": z(64, 16), "bias": z(16)},
        }}},
    }
    got = _flat(tensor.tensor_parallel_specs(params))
    assert got == _flat(jtensor.tensor_parallel_specs(params))
    assert got["block.residual_1.main.dense_1.kernel"] == (None, "model")
    assert got["block.residual_1.main.dense_2.kernel"] == ("model", None)
    assert got["block.residual_1.main.dense_2.bias"] == ()
    assert got["dense.kernel"] == (None, "model")


def test_optimizer_state_inherits_param_specs():
    jmodel = jlm(VOCAB, SEQ, d_model=32, depth=1, num_heads=4)
    jparams = jmodel.init(0)["params"]
    want = jtensor.specs_like_params(
        tdj.ops.Adam(1e-3).init(jparams),
        jtensor.tensor_parallel_specs(jparams))
    model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                 num_heads=4)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    state = optimizers.Adam(1e-3).init(params)
    tree = AdamState(step=state.step, mu=_nest(zip(names, state.mu)),
                     nu=_nest(zip(names, state.nu)))
    got = tensor.specs_like_params(
        tree, tensor.tensor_parallel_specs(_nest(model.named_parameters())))
    assert _flat(got.mu) == _flat(want.mu)
    assert _flat(got.nu) == _flat(want.nu)
    assert got.step == tuple(want.step) == ()
    assert got.mu["block"]["residual"]["main"]["multiheadattention"][
        "wq"] == (None, "model")


# -- the fits ------------------------------------------------------------------------

@pytest.mark.multiprocess
@pytest.mark.parametrize("n", sorted(AXES))
def test_fit_equals_the_references_on_the_same_mesh(run, n):
    outs, ref = run["outs"][n], run["refs"][n]
    assert [o["rank"] for o in outs] == list(range(n))
    assert all(o["replicas"] == AXES[n]["data"] for o in outs)
    assert all(o["loss"] == outs[0]["loss"] for o in outs)
    np.testing.assert_allclose(outs[0]["loss"], ref["loss"], **TOL)
    arrays = run["arrays"][n][0]
    np.testing.assert_allclose(arrays["preds"], ref["preds"], **TOL)
    for name, want in ref["params"].items():
        got = arrays["p/" + name]
        if name.endswith(".bk"):
            assert np.abs(got - want.numpy()).max() <= 2 * LR * EPOCHS * \
                STEPS, name
            continue
        np.testing.assert_allclose(got, want.numpy(), err_msg=name, **TOL)


def _pruned_specs(n: int) -> dict:
    """``{name: spec}`` of the LM's leaves on the mesh of ``n`` workers,
    after ``prune_indivisible``."""
    model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                 num_heads=4)
    tree = _nest(model.named_parameters())
    mesh = mesh_lib.Mesh(tuple(AXES[n]), tuple(AXES[n].values()),
                         torch.device("cpu"))
    return _flat(tensor.prune_indivisible(
        tensor.tensor_parallel_specs(tree), tree, mesh))


@pytest.mark.multiprocess
@pytest.mark.parametrize("n", sorted(AXES))
def test_each_process_holds_the_blocks_its_spec_names(run, n):
    arrays = run["arrays"][n]
    specs = _pruned_specs(n)
    assert specs["block.residual.main.multiheadattention.wq"] == (None,
                                                                  "model")
    for r, a in enumerate(arrays):
        m = r % 2  # the model coordinate: the inner axis
        for name, spec in specs.items():
            full, local = a["p/" + name], a["l/" + name]
            if "model" in spec:
                dim = spec.index("model")
                per = full.shape[dim] // 2
                want = np.take(full, range(m * per, (m + 1) * per), dim)
                np.testing.assert_array_equal(local, want, err_msg=name)
                assert a["mu/" + name].shape == local.shape
            else:
                assert local.shape == full.shape
    wq = "l/block.residual.main.multiheadattention.wq"
    assert arrays[0][wq].shape == (32, 16)


@pytest.mark.multiprocess
@pytest.mark.parametrize("n", sorted(AXES))
def test_replicated_leaves_are_bit_equal_across_the_model_axis(run, n):
    a, b = run["arrays"][n][:2]  # model coordinates 0 and 1
    replicated = [name for name, spec in _pruned_specs(n).items()
                  if "model" not in spec]
    assert "embedding.table" in replicated and "dense.kernel" in replicated
    for name in replicated:
        for kind in ("l/", "mu/"):
            np.testing.assert_array_equal(a[kind + name], b[kind + name],
                                          err_msg=kind + name)


@pytest.mark.multiprocess
def test_a_model_axis_over_a_convnet_trains_as_one_process(run):
    # The rules shard the CNN's Dense pair (column, then row); the
    # convolutions stay replicated.
    for o in run["outs"][2]:
        assert o["cnn_layout"] == ["dense.bias", "dense.kernel",
                                   "dense_1.kernel"]
        np.testing.assert_allclose(o["cnn_loss"], run["cnn_loss"], **TOL)


@pytest.mark.multiprocess
def test_heads_the_axis_does_not_divide_stay_whole(run):
    # 3 heads over 2 processes: wq's 30 columns divide, its heads do not,
    # so the attention is replicated and every process runs all 3 heads.
    for o in run["outs"][2]:
        assert not [n for n in o["odd_heads_layout"]
                    if "multiheadattention" in n]
        assert "block.residual_1.main.dense.kernel" in o["odd_heads_layout"]
        np.testing.assert_allclose(o["odd_heads_loss"],
                                   run["odd_heads_loss"], **TOL)


@pytest.mark.multiprocess
def test_mixed_bfloat16_composes_with_the_model_axis(run):
    for o in run["outs"][2]:
        assert np.isfinite(o["bf16_loss"]).all() and np.isfinite(
            o["bf16_eval"])
        assert o["bf16_wq"] == ["torch.float32", [32, 16]]
    assert run["outs"][2][0]["bf16_loss"] == run["outs"][2][1]["bf16_loss"]


@pytest.mark.multiprocess
def test_checkpoints_restore_across_topologies(run):
    # {data: 2, model: 2} -> {data: 4}.
    for o in run["outs"][4]:
        assert o["data4_step"] == 2
        np.testing.assert_allclose(o["data4_post"], o["ref_post"], **TOL)
    # One process -> {model: 2}.
    for o in run["outs"][2]:
        assert o["from_single_step"] == 2
        np.testing.assert_allclose(o["from_single_post"],
                                   run["single_post"], **TOL)
    # {model: 2} -> one process.
    step, post = run["restored"]
    assert step == 2
    np.testing.assert_allclose(post, run["outs"][2][0]["tp2_post"], **TOL)


@pytest.mark.multiprocess
def test_the_tensor_parallel_example_runs(run):
    for o in run["outs"][2]:
        ex = o["example"]
        assert ex["wq_global"] == [32, 32] and ex["wq_local"] == [32, 16]
        assert np.isfinite(ex["loss"]).all()
