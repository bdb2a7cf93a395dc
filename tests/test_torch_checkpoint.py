"""Checkpoints: the port's ``training/checkpoint.py`` against the JAX
package's, on the CPU.

A v1 directory written by either package restores into the other
(``restore_model``): parameters, BatchNorm state and optimizer state, for
the CNN under Adam, momentum SGD, scheduled SGD and plain SGD, and for a
narrow residual net with more than ten convs in one container (so the
reference's sorted keys put ``conv2d_10`` before ``conv2d_2``, and only a
mapping by name lands each tensor where it belongs). Key sets are equal,
values equal to the byte (the same fp32), and a fit continued from either
side matches the reference's continued fit at atol = rtol = 1e-5. Then
the checkpoint machinery itself: a corrupt step is skipped for the one
before it, ``max_to_keep``, restore in place (no tensor replaced, no new
leaf table), the async writer's error delivery, ``fit(checkpoint_dir=)``
resuming as the reference resumes and, with Dropout, equal to the
uninterrupted fit; and two gloo workers resuming from the chief's files,
the other process reading none.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.models import resnet as jresnet
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist.data import pipeline as jpipeline
from tpu_dist.ops import schedules as jsched
from tpu_dist.training import checkpoint as jckpt
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import Sequential, bridge, cnn, layers, resnet
from tpu_dist_torch.models.bridge import variables_from_jax
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.ops import losses, optimizers, schedules
from tpu_dist_torch.training import (AsyncCheckpointer, ModelCheckpoint,
                                     checkpoint)
from test_torch_multiworker import _run_workers

TOL = dict(atol=1e-5, rtol=1e-5)

#: name -> (reference optimizer, port optimizer, keys of the CNN's npz)
OPTIMIZERS = {
    "adam": (lambda: jopt.Adam(0.01), lambda: optimizers.Adam(0.01), 25),
    "momentum": (lambda: jopt.SGD(0.05, momentum=0.9),
                 lambda: optimizers.SGD(0.05, momentum=0.9), 16),
    "scheduled": (
        lambda: jopt.SGD(jsched.ExponentialDecay(0.05, 2, 0.5),
                         momentum=0.9),
        lambda: optimizers.SGD(schedules.ExponentialDecay(0.05, 2, 0.5),
                               momentum=0.9), 17),
    "plain": (lambda: jopt.SGD(0.05), lambda: optimizers.SGD(0.05), 8),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_bytes(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_arrays(model) -> dict:
    """The port model's checkpoint tensors as host arrays, by key."""
    return {k: t.detach().cpu().numpy() for k, t in bridge.checkpoint_tensors(
        model, model._trainer.variables["opt"]).items()}


def _ref_arrays(jmodel) -> dict:
    v = jmodel.variables
    return {k: np.asarray(a) for k, a in bridge.flatten_keys(
        {k: v[k] for k in ("params", "state", "opt")}).items()}


def _loss(jax_side: bool):
    mod = jlosses if jax_side else losses
    return mod.SparseCategoricalCrossentropy(from_logits=True)


def _cnn_pair(name):
    jopt_fn, topt_fn, _ = OPTIMIZERS[name]
    jm, tm = jcnn.build_cnn_model(), cnn.build_cnn_model()
    tm.load_jax_variables(_np(jm.init(0)))
    jm.compile(optimizer=jopt_fn(), loss=_loss(True))
    tm.compile(optimizer=topt_fn(), loss=_loss(False), device="cpu")
    return jm, tm


def _cnn_data(rows=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, rows))


def _both_directions(jm, tm, make_jm, data, tmp_path, n_keys=None):
    """The reference fits an epoch and saves; the port restores it (byte
    for byte), saves it again (the reference's keys and bytes) and the
    reference restores that into a fresh model; then both continue."""
    jm.fit(data, epochs=1, verbose=0)
    jckpt.save(tmp_path / "jax", jm, step=0)
    written = _npz(tmp_path / "jax" / "ckpt-0" / "arrays.npz")
    if n_keys is not None:
        assert len(written) == n_keys
    assert checkpoint.restore_model(tmp_path / "jax", tm) == 0
    _assert_same_bytes(_port_arrays(tm), written)

    checkpoint.save(tmp_path / "port", tm, step=0)
    ours = _npz(tmp_path / "port" / "ckpt-0" / "arrays.npz")
    _assert_same_bytes(ours, written)
    # A variables tree is keyed as jax.tree_util.keystr keys it: the
    # reference's own tree, saved by the port, gives the same file.
    v = jm.variables
    checkpoint.save(tmp_path / "tree", {k: _np(v[k]) for k in
                                        ("params", "state", "opt")}, step=0)
    _assert_same_bytes(_npz(tmp_path / "tree" / "ckpt-0" / "arrays.npz"),
                       written)
    manifests = [json.loads((tmp_path / d / "ckpt-0" / "manifest.json")
                            .read_text()) for d in ("jax", "port")]
    # device_count stamps each runtime's topology: the reference's CPU
    # mesh has 8 devices here, the port one device per process.
    assert manifests[1].pop("device_count") == manifests[1]["process_count"]
    manifests[0].pop("device_count")
    assert manifests[0] == manifests[1]
    assert (tmp_path / "port" / "checkpoint").read_text() == "0"

    jm2 = make_jm()
    assert jckpt.restore_model(tmp_path / "port", jm2) == 0
    _assert_same_bytes(_ref_arrays(jm2), written)

    # Continued from either side: the port from the reference's files,
    # the reference from the port's.
    th = tm.fit(data, epochs=1, verbose=0).history
    jh = jm2.fit(data, epochs=1, verbose=0).history
    np.testing.assert_allclose(th["loss"], [float(v) for v in jh["loss"]],
                               **TOL)
    want, got = _ref_arrays(jm2), _port_arrays(tm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    return written


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_cnn_checkpoints_cross_both_ways(name, tmp_path):
    jm, tm = _cnn_pair(name)

    def make_jm():
        m = jcnn.build_cnn_model()
        m.compile(optimizer=OPTIMIZERS[name][0](), loss=_loss(True))
        return m

    written = _both_directions(jm, tm, make_jm, _cnn_data(), tmp_path,
                               n_keys=OPTIMIZERS[name][2])
    opt_keys = sorted(k for k in written if k.startswith("['opt']"))
    if name == "adam":
        assert "['opt'].step" in written and written["['opt'].step"].dtype \
            == np.int32 and written["['opt'].step"].shape == ()
        assert "['opt'].mu['conv2d']['kernel']" in written
    elif name == "momentum":
        assert opt_keys[0] == "['opt']['conv2d']['bias']"
    elif name == "scheduled":
        assert "['opt'].velocity['dense_1']['kernel']" in written
        assert "['opt'].step" in written
    else:
        assert opt_keys == []


def _deep_layers(jax_side: bool):
    """A narrow residual net with eleven conv + BatchNorm pairs in the
    model's own container, then a residual block."""
    L, R = (jlayers, jresnet) if jax_side else (layers, resnet)
    chain = [x for _ in range(11) for x in R._conv_bn(2, 3)]
    return [*chain, R._basic_block(2, 1, True), L.GlobalAveragePooling2D(),
            L.Dense(10)]


def test_resnet_state_and_names_past_ten_cross_both_ways(tmp_path):
    def make_jm():
        m = jmodel_lib.Sequential(_deep_layers(True), input_shape=(6, 6, 1),
                                  name="deep")
        m.compile(optimizer=jopt.Adam(0.01), loss=_loss(True))
        return m

    jm = make_jm()
    tm = Sequential(_deep_layers(False), input_shape=(6, 6, 1), name="deep")
    tm.load_jax_variables(_np(jm.init(0)))
    tm.compile(optimizer=optimizers.Adam(0.01), loss=_loss(False),
               device="cpu")
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((32, 6, 6, 1)).astype(np.float32),
            rng.integers(0, 10, 32))
    written = _both_directions(jm, tm, make_jm, data, tmp_path)
    names = [n for n, _ in tm.named_parameters()]
    assert names.index("conv2d_2.kernel") < names.index("conv2d_10.kernel")
    keys = sorted(written)
    assert (keys.index("['opt'].mu['conv2d_10']['kernel']")
            < keys.index("['opt'].mu['conv2d_2']['kernel']"))
    state = [k for k in written if k.startswith("['state']")]
    assert len(state) == 2 * (11 + 3)      # mean and var of 14 BatchNorms
    assert not np.allclose(written["['state']['batchnormalization_10']"
                                   "['mean']"], 0.0)


def test_bridge_moves_optimizer_state_both_ways():
    jm, tm = _cnn_pair("adam")
    jm.fit(_cnn_data(), epochs=1, verbose=0)
    tm._get_trainer("").ensure_variables()
    opt = tm._trainer.variables["opt"]
    names = [n for n, _ in tm.named_parameters()]
    bridge.load_jax_opt_state(_np(jm.variables["opt"]), opt, names)
    back = bridge.opt_state_to_jax(opt, names)
    want = {k: np.asarray(v) for k, v in
            bridge.flatten_keys(jm.variables["opt"]).items()}
    _assert_same_bytes(back, want)
    with pytest.raises(KeyError, match="optimizer state keys differ"):
        bridge.load_jax_opt_state({"mu": {}}, opt, names)


def _small(seed=0, dropout=0.0, optimizer=None):
    model = Sequential([layers.Dense(8, activation="relu"),
                        layers.Dropout(dropout), layers.Dense(3)],
                       input_shape=(5,), name="small", seed=seed)
    model.compile(optimizer=optimizer or optimizers.Adam(0.05),
                  loss=_loss(False), device="cpu")
    return model


def _small_data(rows=64):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((rows, 5)).astype(np.float32)
    return Dataset.from_tensor_slices((x, rng.integers(0, 3, rows))).batch(16)


def test_a_corrupt_step_is_skipped_for_the_one_before(tmp_path):
    model = _small()
    for step in range(3):
        checkpoint.save(tmp_path, model, step=step)
    arrays = tmp_path / "ckpt-2" / "arrays.npz"
    arrays.write_bytes(arrays.read_bytes()[:100])      # a torn write
    assert checkpoint.latest_step(tmp_path) == 2
    assert not checkpoint.is_complete(tmp_path, 2)
    assert "unreadable" in checkpoint.validate_step_dir(tmp_path / "ckpt-2")
    assert checkpoint.latest_complete_step(tmp_path) == 1
    assert jckpt.latest_complete_step(tmp_path) == 1
    assert checkpoint.restore_model(tmp_path, model) == 1
    with pytest.raises(ValueError, match="failed validation"):
        checkpoint.restore_model(tmp_path, model, step=2)
    (tmp_path / "ckpt-1" / "manifest.json").write_text("{")
    assert checkpoint.latest_complete_step(tmp_path) == 0
    assert checkpoint.latest_complete_step(tmp_path, before=0) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_model(tmp_path / "empty", model)


def test_max_to_keep_keeps_the_newest_steps(tmp_path):
    model = _small()
    for step in range(5):
        checkpoint.save(tmp_path / "sync", model, step=step, max_to_keep=2)
    assert checkpoint.all_steps(tmp_path / "sync") == [3, 4]
    model.fit(_small_data(), epochs=4, verbose=0, callbacks=[
        ModelCheckpoint(str(tmp_path / "cb"), max_to_keep=2)])
    assert checkpoint.all_steps(tmp_path / "cb") == [2, 3]
    assert jckpt.all_steps(tmp_path / "cb") == [2, 3]
    assert checkpoint.latest_step(tmp_path / "cb") == 3


def test_restore_is_in_place_and_builds_no_leaf_table(tmp_path):
    model = _small(optimizer=optimizers.SGD(0.05, momentum=0.9, fused=True))
    model.fit(_small_data(), epochs=1, verbose=0)
    checkpoint.save(tmp_path, model, step=0)
    want = _port_arrays(model)
    model.fit(_small_data(), epochs=1, verbose=0)
    trainer = model._trainer
    params = trainer.variables["params"]
    vel = trainer.variables["opt"]
    tables = model.optimizer._tables
    grads = [torch.zeros_like(p) for p in params]
    first = tables.get(-1, params, grads, (vel,))
    held = {k: (id(t), t.data_ptr()) for k, t in
            bridge.checkpoint_tensors(model, vel).items()}
    checkpoint.restore_model(tmp_path, model)
    _assert_same_bytes(_port_arrays(model), want)
    after = bridge.checkpoint_tensors(model, trainer.variables["opt"])
    assert {k: (id(t), t.data_ptr()) for k, t in after.items()} == held
    assert tables.get(-1, params, grads, (vel,)) is first
    assert tables.builds == 1


def test_async_checkpointer_writes_and_delivers_errors_late(tmp_path):
    model = _small()
    with AsyncCheckpointer(tmp_path / "ok", max_to_keep=3) as ckpt:
        for step in range(4):
            ckpt.save_async(model, step=step)
        assert ckpt.in_flight_step == 3
    assert ckpt.in_flight_step is None
    assert checkpoint.all_steps(tmp_path / "ok") == [1, 2, 3]
    _assert_same_bytes(_npz(tmp_path / "ok" / "ckpt-3" / "arrays.npz"),
                       _port_arrays(model))
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the directory should be")
    ckpt = AsyncCheckpointer(blocked)
    ckpt.save_async(model, step=7)          # fails on the writer thread
    with pytest.raises(OSError) as err:
        ckpt.save_async(model, step=8)      # ... and surfaces here
    assert err.value.checkpoint_step == 7
    with pytest.raises(OSError):
        ckpt.wait()
    # The sharded v2 layout, async and sync: one process holds every
    # leaf whole, so the chief's arrays.npz carries the same bytes.
    with AsyncCheckpointer(tmp_path / "v2", sharded=True) as ckpt:
        ckpt.save_async(model, step=0)
    checkpoint.save(tmp_path / "v2", model, step=1, sharded=True)
    for step in (0, 1):
        _assert_same_bytes(
            _npz(tmp_path / "v2" / f"ckpt-{step}" / "arrays.npz"),
            _port_arrays(model))


def _resumed_fit_pair(tmp_path, epochs_first, epochs, seed=0, dropout=0.0):
    first = _small(dropout=dropout)
    first.fit(_small_data(), epochs=epochs_first, verbose=0, seed=seed,
              checkpoint_dir=str(tmp_path))
    resumed = _small(dropout=dropout)
    h = resumed.fit(_small_data(), epochs=epochs, verbose=0, seed=seed,
                    checkpoint_dir=str(tmp_path))
    return resumed, h


def test_fit_resumes_as_the_reference_resumes(tmp_path):
    tm_first = _small()
    jm = jmodel_lib.Sequential([jlayers.Dense(8, activation="relu"),
                                jlayers.Dropout(0.0), jlayers.Dense(3)],
                               input_shape=(5,), name="small")
    tm_first.load_jax_variables(_np(jm.init(0)))
    init = {k: v.clone() for k, v in tm_first.state_dict().items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    y = rng.integers(0, 3, 64)
    tm_first.fit((x, y), epochs=2, verbose=0,
                 checkpoint_dir=str(tmp_path / "port"))
    tm = _small()
    tm.load_state_dict(init)
    th = tm.fit((x, y), epochs=3, verbose=0,
                checkpoint_dir=str(tmp_path / "port")).history

    def jfit(epochs):
        m = jmodel_lib.Sequential([jlayers.Dense(8, activation="relu"),
                                   jlayers.Dropout(0.0), jlayers.Dense(3)],
                                  input_shape=(5,), name="small")
        m.compile(optimizer=jopt.Adam(0.05), loss=_loss(True))
        return m, m.fit((x, y), epochs=epochs, verbose=0,
                        checkpoint_dir=str(tmp_path / "jax")).history

    jfit(2)
    jm, jh = jfit(3)
    assert len(th["loss"]) == len(jh["loss"]) == 1     # epoch 2 alone
    np.testing.assert_allclose(th["loss"], [float(v) for v in jh["loss"]],
                               **TOL)
    for k, want in _ref_arrays(jm).items():
        np.testing.assert_allclose(_port_arrays(tm)[k], want, err_msg=k,
                                   **TOL)
    assert checkpoint.all_steps(tmp_path / "port") == [0, 1, 2] == \
        jckpt.all_steps(tmp_path / "jax")


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_resumed_fit_equals_the_uninterrupted_fit(tmp_path, dropout):
    resumed, h = _resumed_fit_pair(tmp_path, 2, 4, seed=5, dropout=dropout)
    straight = _small(dropout=dropout)
    hs = straight.fit(_small_data(), epochs=4, verbose=0, seed=5).history
    assert h.history["loss"] == hs["loss"][2:]
    _assert_same_bytes(_port_arrays(resumed), _port_arrays(straight))


def test_restore_step_from_the_environment(tmp_path, monkeypatch):
    _small().fit(_small_data(), epochs=3, verbose=0,
                 checkpoint_dir=str(tmp_path))
    monkeypatch.setenv("TPU_DIST_RESTORE_STEP", "0")
    h = _small().fit(_small_data(), epochs=3, verbose=0,
                     checkpoint_dir=str(tmp_path)).history
    assert len(h["loss"]) == 2                  # epochs 1 and 2 again
    monkeypatch.setenv("TPU_DIST_RESTORE_STEP", "none")
    h = _small().fit(_small_data(), epochs=3, verbose=0,
                     checkpoint_dir=str(tmp_path)).history
    assert len(h["loss"]) == 3
    # A ModelCheckpoint of the same directory is not doubled: its sync
    # saves are the only ones.
    cb = ModelCheckpoint(str(tmp_path), async_save=False)
    metrics.get_registry().reset()
    metrics.enable()
    try:
        _small().fit(_small_data(), epochs=2, verbose=0, callbacks=[cb],
                     checkpoint_dir=pathlib.Path(tmp_path))
        counters = metrics.get_registry().snapshot()["counters"]
    finally:
        metrics.disable()
    assert counters.get("checkpoint.sync_saves") == 2
    assert "checkpoint.async_saves" not in counters


RESUME_WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models import layers
from tpu_dist_torch.ops import losses, optimizers

weights, arrays, ckpt, out = sys.argv[1:5]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
a = np.load(arrays)
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.DATA


def fit(epochs):
    ds = td.data.Dataset.from_tensor_slices((a["x"], a["y"])).batch(16)
    with strategy.scope():
        model = td.models.Sequential(
            [layers.Dense(8, activation="relu"), layers.Dense(3)],
            input_shape=(5,), name="small", seed=td.cluster.process_index())
        if td.cluster.is_chief():
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in np.load(weights).items()})
        model.compile(optimizer=optimizers.Adam(0.05),
                      loss=losses.SparseCategoricalCrossentropy(
                          from_logits=True))
    # Each process names its own directory: only the chief's holds files.
    h = model.fit(ds.with_options(options), epochs=epochs, verbose=0,
                  checkpoint_dir=ckpt)
    return model, h.history


fit(1)
model, history = fit(2)
opt = model._trainer.variables["opt"]
np.savez(out, **{k: v.numpy() for k, v in model.state_dict().items()},
         step=opt.step.numpy())
print(json.dumps({"rank": td.cluster.process_index(),
                  "loss": history["loss"]}))
'''


@pytest.mark.multiprocess
def test_two_gloo_workers_resume_from_the_chiefs_files(tmp_path):
    def make():
        m = jmodel_lib.Sequential([jlayers.Dense(8, activation="relu"),
                                   jlayers.Dense(3)], input_shape=(5,),
                                  name="small")
        m.compile(optimizer=jopt.Adam(0.05), loss=_loss(True))
        return m

    jm = make()
    init = _np(jm.init(0))
    np.savez(tmp_path / "init.npz",
             **{k: v.numpy() for k, v in variables_from_jax(init).items()})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    y = rng.integers(0, 3, 64)
    np.savez(tmp_path / "arrays.npz", x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(RESUME_WORKER)
    outs = _run_workers(script, ["init.npz", "arrays.npz", "ckpt{rank}",
                                 "state{rank}.npz"], tmp_path)
    assert checkpoint.all_steps(tmp_path / "ckpt0") == [0, 1]
    assert checkpoint.all_steps(tmp_path / "ckpt1") == []
    assert outs[0]["loss"] == outs[1]["loss"] and len(outs[0]["loss"]) == 1
    states = [dict(np.load(tmp_path / f"state{r}.npz")) for r in (0, 1)]
    _assert_same_bytes(states[1], states[0])
    assert int(states[0]["step"]) == 8          # Adam's count, restored

    def batches():
        return jpipeline.Dataset.from_tensor_slices((x, y)).batch(16)

    make().fit(batches(), epochs=1, verbose=0,
               checkpoint_dir=str(tmp_path / "jax"))
    jm = make()
    jh = jm.fit(batches(), epochs=2, verbose=0,
                checkpoint_dir=str(tmp_path / "jax")).history
    np.testing.assert_allclose(outs[0]["loss"], [float(v) for v in
                                                 jh["loss"]], **TOL)
    for name, value in variables_from_jax(_np(jm.variables)).items():
        np.testing.assert_allclose(states[0][name], value.numpy(),
                                   err_msg=name, **TOL)
