"""The port's faults F1, F2, F4 and F5 and the two minor ones, each held to
the JAX package on the CPU (``ROADMAP.md`` queue 3 gives each one's
reproduction, which these tests are).

* F1: ``predict`` on a plain ``Dataset`` whose uint8 batches carry their
  scale as ``_device_transform`` (a native pipeline) applies it, as the
  reference does: within 1e-5 of the reference's outputs on bridged
  weights (the unscaled bytes were 0.28 off).
* F2: ``Model.init(seed, input_shape)``, ``Model.apply(params, state, x,
  training=, rng=)`` and ``model(variables, x)``, the reference's
  functional core: outputs and new state equal to the reference's on the
  same variables at 1e-5, the model's own tensors untouched,
  ``nn.Module.apply(fn)`` still working.
* F4: a functional model's ``aux_loss`` state leaf joins the objective
  under autograd: loss, History and parameters equal to the reference's
  at 1e-5 (the port reported 4.971 against 52.244), eagerly and in a
  k-step execution.
* F5: sync-BN's variance centres first: two gloo workers on data offset by
  100 match the reference's single-process fit in losses and the moments
  of the BatchNorm on that input at atol = rtol = 1e-5 (``Σx²/n −
  mean²`` was 8e-5 off in its running variance), and the port's
  single-process fit in every parameter and buffer.
* The ``unported`` errors name the queue-1 item of ``ROADMAP.md``, and an
  initializer the reference does not list raises the reference's
  ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.data import native as jnative
from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.models import resnet as jresnet
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import native
from tpu_dist_torch.models import Model, Sequential, cnn, layers, resnet
from tpu_dist_torch.models.bridge import variables_from_jax
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import MirroredStrategy
from tpu_dist_torch.serve import fleet
from tpu_dist_torch.utils.errors import unported
from test_torch_multiworker import _run_workers

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


# -- F1 ------------------------------------------------------------------------

def test_predict_applies_a_plain_datasets_device_transform():
    kw = dict(global_batch_size=16, synthetic_size=64, transfer="uint8")
    jm = jcnn.build_cnn_model()
    variables = _np(jm.init(0))
    tm = cnn.build_cnn_model()
    tm.load_jax_variables(variables)
    tm.to("cpu")
    ours = native.native_pipeline("mnist", **kw)
    assert ours._device_transform is not None
    got = tm.predict(ours)
    want = np.asarray(jm.predict(jnative.native_pipeline("mnist", **kw)))
    assert got.shape == want.shape == (64, 10)
    np.testing.assert_allclose(got, want, **TOL)


# -- F2 ------------------------------------------------------------------------

def _jcounter_init(key, shape):
    return ({"dense": {"kernel": 0.3 * jax.random.normal(key, (shape[-1], 4)),
                       "bias": jnp.zeros(4)}},
            {"count": jnp.zeros((), jnp.float32)})


def _jcounter_apply(params, state, x, training, rng):
    y = x @ params["dense"]["kernel"] + params["dense"]["bias"]
    return y, ({"count": state["count"] + 1.0} if training else state)


def _tcounter_init(gen, shape):
    return ({"dense": {"kernel": 0.3 * torch.randn(shape[-1], 4,
                                                   generator=gen),
                       "bias": torch.zeros(4)}},
            {"count": torch.zeros(())})


def _tcounter_apply(params, state, x, training, rng):
    y = x @ params["dense"]["kernel"] + params["dense"]["bias"]
    return y, ({"count": state["count"] + 1.0} if training else state)


def _narrow_bn_pair():
    jm = jmodel_lib.Sequential(
        [*jresnet._conv_bn(4, 3), jlayers.Flatten(), jlayers.Dense(3)],
        input_shape=(5, 5, 2), name="bn")
    tm = Sequential([*resnet._conv_bn(4, 3), layers.Flatten(),
                     layers.Dense(3)], input_shape=(5, 5, 2), name="bn")
    return jm, tm


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_untouched(model, before):
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("training", [False, True])
def test_sequential_apply_is_the_references_functional_apply(training):
    jm, tm = _narrow_bn_pair()
    variables = _np(jm.init(0))
    x = np.random.default_rng(1).standard_normal((6, 5, 5, 2)).astype(
        np.float32) + 3.0
    before = _snapshot(tm)
    out, new_state = tm.apply(_torch(variables["params"]),
                              _torch(variables["state"]), torch.from_numpy(x),
                              training=training)
    jout, jstate = jm.apply(variables["params"], variables["state"], x,
                            training=training)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    want = variables_from_jax({"params": {}, "state": _np(jstate)})
    got = variables_from_jax({"params": {}, "state": _np(
        jax.tree_util.tree_map(lambda t: t.numpy(), new_state))})
    assert set(got) == set(want) == {"batchnormalization.mean",
                                     "batchnormalization.var"}
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    moved = not np.allclose(want["batchnormalization.mean"].numpy(), 0.0)
    assert moved == training
    _assert_untouched(tm, before)
    assert tm.training is False
    # model(variables, x) is apply's output; model(x) the module's forward.
    call = tm({k: _torch(v) for k, v in variables.items()},
              torch.from_numpy(x))
    if not training:
        np.testing.assert_allclose(call.detach().numpy(), np.asarray(jout),
                                   **TOL)
    assert tm(torch.from_numpy(x)).shape == (6, 3)


def test_init_returns_fresh_variables_and_leaves_the_model_alone():
    _, tm = _narrow_bn_pair()
    before = _snapshot(tm)
    v = tm.init(0)
    _assert_untouched(tm, before)
    # The variables a model built with that seed starts from, in the
    # reference's tree layout.
    assert set(v) == {"params", "state"}
    flat = variables_from_jax(jax.tree_util.tree_map(lambda t: t.numpy(), v))
    assert set(flat) == set(before)
    for k in before:
        assert torch.equal(flat[k], before[k]), k
    other = tm.init(1, input_shape=(5, 5, 2))
    assert not torch.equal(other["params"]["conv2d"]["kernel"],
                           v["params"]["conv2d"]["kernel"])
    fm = Model(_tcounter_init, _tcounter_apply, input_shape=(5,))
    fv = fm.init(3)
    assert set(fv["params"]["dense"]) == {"kernel", "bias"}
    with pytest.raises(ValueError, match="input_shape"):
        Model(_tcounter_init, _tcounter_apply).init(0)


def test_functional_model_apply_and_module_apply():
    jm = jmodel_lib.Model(_jcounter_init, _jcounter_apply, input_shape=(5,))
    tm = Model(_tcounter_init, _tcounter_apply, input_shape=(5,))
    variables = _np(jm.init(0))
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    before = _snapshot(tm)
    out, st = tm.apply(_torch(variables["params"]),
                       _torch(variables["state"]), torch.from_numpy(x),
                       training=True, rng=torch.Generator())
    jout, jst = jm.apply(variables["params"], variables["state"], x,
                         training=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert float(st["count"]) == float(jst["count"]) == 1.0
    _assert_untouched(tm, before)
    # nn.Module.apply(fn) keeps working for one callable.
    seen = []
    assert tm.apply(lambda m: seen.append(type(m).__name__)) is tm
    assert "Model" in seen


# -- F4 ------------------------------------------------------------------------

AUX = 10.0


def _jaux_init(key, shape):
    return ({"dense": {"kernel": 0.5 * jax.random.normal(key, (shape[-1], 3)),
                       "bias": jnp.zeros(3)}},
            {"aux_loss": jnp.zeros((), jnp.float32)})


def _jaux_apply(params, state, x, training, rng):
    k = params["dense"]["kernel"]
    return x @ k + params["dense"]["bias"], {"aux_loss": AUX * jnp.sum(k * k)}


def _taux_init(gen, shape):
    return ({"dense": {"kernel": 0.5 * torch.randn(shape[-1], 3,
                                                   generator=gen),
                       "bias": torch.zeros(3)}},
            {"aux_loss": torch.zeros(())})


def _taux_apply(params, state, x, training, rng):
    k = params["dense"]["kernel"]
    return x @ k + params["dense"]["bias"], {"aux_loss": AUX * (k * k).sum()}


@pytest.mark.parametrize("k", [1, 2])
def test_aux_loss_leaves_join_the_objective(k):
    jm = jmodel_lib.Model(_jaux_init, _jaux_apply, input_shape=(4,))
    tm = Model(_taux_init, _taux_apply, input_shape=(4,))
    variables = _np(jm.init(0))
    tm.load_jax_variables(variables)
    rng = np.random.default_rng(0)
    rows = 8 if k == 1 else 64
    x = rng.standard_normal((rows, 4)).astype(np.float32)
    y = rng.integers(0, 3, rows)
    jm.compile(optimizer=jopt.SGD(learning_rate=0.01), steps_per_execution=k,
               loss=jlosses.SparseCategoricalCrossentropy(from_logits=True))
    tm.compile(optimizer=optimizers.SGD(learning_rate=0.01),
               loss=losses.SparseCategoricalCrossentropy(from_logits=True),
               steps_per_execution=k, device="cpu")
    jh = jm.fit((x, y), epochs=2, verbose=0).history
    th = tm.fit((x, y), epochs=2, verbose=0).history
    want = [float(v) for v in jh["loss"]]
    assert want[0] > 20.0    # the aux term dominates: 10·Σw² ≈ 10·12·0.25
    np.testing.assert_allclose(th["loss"], want, **TOL)
    ref = variables_from_jax(_np(jm.variables))
    for name, value in ref.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(),
                                   value.numpy(), err_msg=name, **TOL)


# -- F5 ------------------------------------------------------------------------

OFFSET, BN_SHAPE, BN_STEPS, BN_BATCH = 100.0, (6, 6, 3), 2, 32

BN_WORKER = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models import layers, resnet
from tpu_dist_torch.ops import losses, optimizers

weights, arrays, out = sys.argv[1:4]
strategy = td.MultiWorkerMirroredStrategy(device="cpu")
a = np.load(arrays)
ds = td.data.Dataset.from_tensor_slices((a["x"], a["y"])).batch(%d)
options = td.data.Options()
options.experimental_distribute.auto_shard_policy = td.AutoShardPolicy.DATA
with strategy.scope():
    model = td.models.Sequential(
        [layers.BatchNormalization(momentum=0.9, epsilon=1e-5),
         *resnet._conv_bn(8, 3), layers.GlobalAveragePooling2D(),
         layers.Dense(10)], input_shape=%r, name="offset")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in np.load(weights).items()})
    model.compile(optimizer=optimizers.SGD(learning_rate=0.1),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True))
history = model.fit(ds.with_options(options), epochs=1, steps_per_epoch=%d,
                    verbose=0).history
np.savez(out, **{k: v.numpy() for k, v in model.state_dict().items()})
print(json.dumps({"rank": td.cluster.process_index(),
                  "loss": history["loss"]}))
''' % (BN_BATCH, BN_SHAPE, BN_STEPS)


@pytest.mark.multiprocess
def test_sync_bn_variance_is_centred_on_off_centre_data(tmp_path):
    # BatchNorm first, on the offset input: mean 100, variance 1 per
    # channel, where Σx²/n − mean² loses about 1e-3 of the variance.
    jm = jmodel_lib.Sequential(
        [jlayers.BatchNormalization(momentum=0.9, epsilon=1e-5),
         *jresnet._conv_bn(8, 3), jlayers.GlobalAveragePooling2D(),
         jlayers.Dense(10)], input_shape=BN_SHAPE, name="offset")
    init = _np(jm.init(0))
    np.savez(tmp_path / "init.npz",
             **{k: v.numpy() for k, v in variables_from_jax(init).items()})
    rng = np.random.default_rng(0)
    x = (OFFSET + rng.standard_normal((BN_STEPS * BN_BATCH, *BN_SHAPE))
         ).astype(np.float32)
    y = rng.integers(0, 10, BN_STEPS * BN_BATCH)
    np.savez(tmp_path / "arrays.npz", x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(BN_WORKER)
    outs = _run_workers(script, ["init.npz", "arrays.npz",
                                 "state{rank}.npz"], tmp_path)
    jm.compile(optimizer=jopt.SGD(learning_rate=0.1),
               loss=jlosses.SparseCategoricalCrossentropy(from_logits=True))
    history = jm.fit((x, y), epochs=1, steps_per_epoch=BN_STEPS,
                     verbose=0).history
    np.testing.assert_allclose(outs[0]["loss"],
                               [float(v) for v in history["loss"]], **TOL)
    state = dict(np.load(tmp_path / "state0.npz"))
    # The moments of the BatchNorm on the offset input, F5's subject.
    ref = variables_from_jax(_np(jm.variables))
    for name in ("batchnormalization.mean", "batchnormalization.var"):
        np.testing.assert_allclose(state[name], ref[name].numpy(),
                                   err_msg=name, **TOL)
    # Everything after it carries x − mean in its gradients, where x near
    # 100 holds 7.6e-6 of precision and the reference's fp32 mean of 1,152
    # values is its own rounding away from the port's: that is held to the
    # port's single-process fit, whose moments (torch.var_mean) centre too.
    single = Sequential([layers.BatchNormalization(momentum=0.9,
                                                   epsilon=1e-5),
                         *resnet._conv_bn(8, 3),
                         layers.GlobalAveragePooling2D(), layers.Dense(10)],
                        input_shape=BN_SHAPE, name="offset")
    single.load_jax_variables(init)
    single.compile(optimizer=optimizers.SGD(learning_rate=0.1),
                   loss=losses.SparseCategoricalCrossentropy(
                       from_logits=True), device="cpu")
    single.fit((x, y), epochs=1, steps_per_epoch=BN_STEPS, verbose=0)
    for name, value in single.state_dict().items():
        np.testing.assert_allclose(state[name], value.numpy(),
                                   err_msg=name, **TOL)


# -- the minor faults ------------------------------------------------------------

@pytest.mark.parametrize("call, item", [
    # Items 12, 17a and 17b ported the data, model, seq, pipe and expert
    # axes, 18b the sharded checkpoint layout and 20 the fleet's leased
    # slots; several devices in one process, a strategy's or a fleet
    # replica's, stay unported.
    (lambda: MirroredStrategy(devices=["cpu", "cpu"]), "12b"),
    (lambda: fleet.ServeFleet(lambda: None, devices_per_replica=2), "12b"),
], ids=["run", "devices_per_replica"])
def test_unported_names_the_roadmap_item(call, item):
    with pytest.raises(NotImplementedError,
                       match=rf"item {item} of queue 1 in ROADMAP\.md"):
        call()
    assert "slice" not in str(unported("x", item))


def test_unknown_initializer_raises_the_references_value_error():
    from tpu_dist.ops import initializers as jinit
    from tpu_dist_torch.ops import initializers

    for get in (jinit.get, initializers.get):
        with pytest.raises(ValueError, match="unknown initializer"):
            get("uniform_scaled")
    with pytest.raises(ValueError, match="unknown initializer"):
        jmodel_lib.Sequential([jlayers.Conv2D(
            2, 3, kernel_initializer="uniform_scaled")],
            input_shape=(5, 5, 1)).init(0)
    with pytest.raises(ValueError, match="unknown initializer"):
        Sequential([layers.Conv2D(2, 3, kernel_initializer="uniform_scaled")],
                   input_shape=(5, 5, 1))
