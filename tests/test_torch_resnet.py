"""The port's ResNet family, its layers and initializers against the
reference's, on the CPU.

The reference's layers and models get their variables from ``init`` and
the port's load them through ``models/bridge.py`` (params and BatchNorm
state). The same NHWC inputs, made with numpy from a seed, go through both.
fp32 on both sides; outputs, gradients, losses, parameters and BatchNorm
running statistics agree at atol = rtol = 1e-5, the other fp32 parity
tests' tolerance (sums run in another order: XLA's reductions and
convolutions against PyTorch's). The narrow residual nets are built from
the private helpers of both ``resnet.py``s; the full-width ResNets are
held to the reference by their trees' names and shapes (``jax.eval_shape``
of the reference's ``init``, nothing allocated) and by ``summary()``'s
text, character for character.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.models import resnet as jresnet
from tpu_dist.ops import initializers as jinit
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import cnn, layers, resnet
from tpu_dist_torch.models.bridge import (params_from_jax, state_from_jax,
                                          variables_from_jax)
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.ops import fused, initializers, losses, metrics
from tpu_dist_torch.ops import optimizers as opt

TOL = dict(atol=1e-5, rtol=1e-5)


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- initializers --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (1, 1, 64, 256),
                                   (512, 10)])
def test_he_normal_matches_the_reference_distribution(shape):
    gen = torch.Generator().manual_seed(0)
    got = initializers.get("he_normal")(gen, shape)
    fan_in, fan_out = initializers._fans(shape)
    assert (fan_in, fan_out) == jinit._fans(shape)
    if len(shape) == 4:
        assert fan_in == shape[0] * shape[1] * shape[2]
    want_std = math.sqrt(2.0 / fan_in)
    ref = np.asarray(jinit.he_normal(jax.random.PRNGKey(0), shape))
    n = got.numel()
    # The sample std of n normals is within 5 / sqrt(2n) of sigma at 5
    # standard errors.
    for sample in (got.numpy(), ref):
        assert abs(sample.std() / want_std - 1) < 5 / math.sqrt(2 * n)
        assert abs(sample.mean()) < 5 * want_std / math.sqrt(n)
    assert torch.equal(got, initializers.he_normal(
        torch.Generator().manual_seed(0), shape))


def test_uniform_scaled_stays_in_its_bounds():
    gen = torch.Generator().manual_seed(1)
    # Called directly, as the ResNet helpers call it: the reference's
    # get() does not list it, and neither does the port's.
    got = initializers.uniform_scaled(gen, (4096,), 0.25)
    ref = np.asarray(jinit.uniform_scaled(jax.random.PRNGKey(1), (4096,),
                                          0.25))
    for sample in (got.numpy(), ref):
        assert sample.min() >= -0.25 and sample.max() <= 0.25
        # Uniform on [-s, s]: std s / sqrt(3).
        assert abs(sample.std() / (0.25 / math.sqrt(3)) - 1) < 0.05
    with pytest.raises(ValueError, match="unknown initializer"):
        initializers.get("lecun_normal")


# -- layers ----------------------------------------------------------------------


def _layer_pair(jlayer, layer, in_shape, seed=0):
    """Both layers initialised for ``in_shape``, the port's loaded with the
    reference's params and state."""
    params, state, jshape = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    shape = layer.init(torch.Generator().manual_seed(0), in_shape)
    assert tuple(shape) == tuple(jshape)
    layer.load_state_dict({**params_from_jax(_host(params)),
                           **state_from_jax(_host(state))})
    return params, state


@pytest.mark.parametrize("in_shape,momentum,epsilon", [
    ((5, 7, 6), 0.99, 1e-3), ((4, 4, 16), 0.9, 1e-5), ((12,), 0.99, 1e-3),
])
def test_batchnorm_matches_reference_in_train_and_eval_mode(
        in_shape, momentum, epsilon):
    jlayer = jlayers.BatchNormalization(momentum=momentum, epsilon=epsilon)
    layer = layers.BatchNormalization(momentum=momentum, epsilon=epsilon)
    params, state = _layer_pair(jlayer, layer, in_shape)
    # Non-trivial gamma, beta and running state on both sides.
    c = in_shape[-1]
    rng = np.random.default_rng(3)
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    layer.load_state_dict({**params_from_jax(params),
                           **state_from_jax(state)})
    x = 3.0 + 2.0 * _images((6, *in_shape), seed=4)
    for training in (False, True):
        want, new_state = jlayer.apply(params, state, jnp.asarray(x),
                                       training=training)
        layer.train(training)
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=f"training={training}", **TOL)
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(layer, name).numpy(),
                                       np.asarray(new_state[name]),
                                       err_msg=name, **TOL)
    # The train-mode update used the biased variance, as the reference.
    xf = torch.from_numpy(x).reshape(-1, c)
    want_var = momentum * state["var"] + (1 - momentum) * xf.var(
        0, unbiased=False).numpy()
    np.testing.assert_allclose(layer.var.numpy(), want_var, **TOL)


def test_batchnorm_keeps_fp32_state_and_returns_the_input_dtype():
    layer = layers.BatchNormalization()
    layer.init(torch.Generator(), (4, 4, 8))
    layer.train()
    y = layer(torch.randn(2, 4, 4, 8).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert layer.mean.dtype == layer.var.dtype == torch.float32
    assert layer.gamma.dtype == torch.float32


@pytest.mark.parametrize("padding,pool,strides,in_shape", [
    ("valid", 2, None, (8, 8, 3)), ("valid", 3, 2, (9, 9, 2)),
    ("same", 2, None, (7, 7, 3)), ("same", 3, 2, (8, 8, 2)),
    ("same", 3, 1, (5, 6, 2)), ("same", 3, 2, (9, 10, 4)),
])
def test_average_pooling_matches_reference(padding, pool, strides, in_shape):
    jlayer = jlayers.AveragePooling2D(pool, strides=strides, padding=padding)
    layer = layers.AveragePooling2D(pool, strides=strides, padding=padding)
    _layer_pair(jlayer, layer, in_shape)
    x = _images((3, *in_shape), seed=5)
    want, _ = jlayer.apply({}, {}, jnp.asarray(x))
    got = layer(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_same_average_pooling_divides_by_the_valid_count():
    layer = layers.AveragePooling2D(3, strides=2, padding="same")
    layer.init(None, (4, 4, 1))
    x = torch.ones(1, 4, 4, 1)
    # Every window averages ones only: the padded zeros are not counted.
    assert torch.equal(layer(x), torch.ones(1, 2, 2, 1))


def test_global_average_pooling_and_activation_match_reference():
    x = _images((3, 5, 6, 4), seed=6)
    for jlayer, layer in [
            (jlayers.GlobalAveragePooling2D(),
             layers.GlobalAveragePooling2D()),
            *[(jlayers.Activation(name), layers.Activation(name))
              for name in ("relu", "tanh", "sigmoid", "gelu", "softmax")]]:
        _layer_pair(jlayer, layer, (5, 6, 4))
        want, _ = jlayer.apply({}, {}, jnp.asarray(x))
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), err_msg=repr(layer),
                                   **TOL)
    relu = layers.ReLU()
    assert type(relu) is layers.Activation and relu.activation == "relu"


# -- narrow residual nets ----------------------------------------------------------

IN_SHAPE = (9, 9, 3)   # odd sizes: the stride-2 SAME convs pad (1, 1)


def _narrow(rlib, llib, seq, **kw):
    """A narrow net from the helpers: a 3x3 stem, a basic stage (stride 2,
    projecting), a bottleneck stage, GAP and a Dense head."""
    return seq([*rlib._conv_bn(8, 3),
                rlib._stage(rlib._basic_block, 8, 2, 2, True),
                rlib._stage(rlib._bottleneck_block, 4, 1, 1, True),
                llib.GlobalAveragePooling2D(), llib.Dense(10)],
               input_shape=IN_SHAPE, name="narrow", **kw)


def _narrow_pair():
    jm = _narrow(jresnet, jlayers, jmodel_lib.Sequential)
    variables = jm.init(0)
    tm = _narrow(resnet, layers, Sequential)
    tm.load_jax_variables(_host(variables))
    return jm, tm, variables


def _assert_variables_close(tm, jvariables, what):
    want = variables_from_jax(_host(jvariables))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   err_msg=f"{what}: {name}", **TOL)


def test_narrow_net_tree_is_the_references():
    jm, tm, variables = _narrow_pair()
    assert sorted(n for n, _ in tm.named_buffers()) == sorted(
        state_from_jax(_host(variables["state"])))
    assert "block.residual.main.batchnormalization.mean" in dict(
        tm.named_buffers())
    assert "block.residual.shortcut.conv2d.kernel" in dict(
        tm.named_parameters())
    # The identity-shortcut block has no shortcut params or state.
    assert not any(n.startswith("block.residual_1.shortcut")
                   for n in tm.state_dict())


def test_narrow_net_forward_and_gradients_match_reference():
    jm, tm, variables = _narrow_pair()
    x = _images((6, *IN_SHAPE), seed=7)
    y = np.random.default_rng(8).integers(0, 10, 6)
    loss_fn = jlosses.SparseCategoricalCrossentropy(from_logits=True)

    def jloss(params):
        logits, new_state = jm.apply(params, variables["state"],
                                     jnp.asarray(x), training=True)
        return loss_fn(logits, jnp.asarray(y)), (logits, new_state)

    (want_loss, (want_logits, want_state)), want_grads = \
        jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = losses.SparseCategoricalCrossentropy(from_logits=True)(
        logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = params_from_jax(_host(want_grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   err_msg=name, **TOL)
    for name, value in state_from_jax(_host(want_state)).items():
        np.testing.assert_allclose(tm.get_buffer(name).numpy(),
                                   value.numpy(), err_msg=name, **TOL)
    # Eval mode: the running state, untouched.
    tm.eval()
    before = {n: b.clone() for n, b in tm.named_buffers()}
    want_eval, _ = jm.apply(variables["params"], want_state, jnp.asarray(x),
                            training=False)
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), **TOL)
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "plain"])
def test_narrow_net_fit_evaluate_predict_match_reference(use_fused):
    jm, tm, _ = _narrow_pair()
    x = _images((80, *IN_SHAPE), seed=9)
    y = np.random.default_rng(10).integers(0, 10, 80)
    jm.compile(optimizer=jopt.SGD(learning_rate=0.05, fused=use_fused),
               loss=jlosses.SparseCategoricalCrossentropy(
                   from_logits=True, fused=use_fused),
               metrics=[jmetrics.SparseCategoricalAccuracy()])
    tm.compile(optimizer=opt.SGD(learning_rate=0.05, fused=use_fused),
               loss=losses.SparseCategoricalCrossentropy(
                   from_logits=True, fused=use_fused),
               metrics=[metrics.SparseCategoricalAccuracy()], device="cpu")
    launches = fused.fused_sgd_apply.launches
    jh = jm.fit((x[:64], y[:64]), epochs=1, steps_per_epoch=2,
                verbose=0).history
    th = tm.fit(Dataset.from_tensor_slices((x[:64], y[:64])).batch(32),
                epochs=1, steps_per_epoch=2, verbose=0).history
    jh2 = jm.fit((x[64:], y[64:]), epochs=1, steps_per_epoch=1,
                 verbose=0).history
    th2 = tm.fit(Dataset.from_tensor_slices((x[64:], y[64:])).batch(32),
                 epochs=1, steps_per_epoch=1, verbose=0).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(
            th[key] + th2[key], [float(v) for v in jh[key] + jh2[key]],
            err_msg=key, **TOL)
    _assert_variables_close(tm, jm.variables, "after 3 steps")
    assert fused.fused_sgd_apply.launches == launches  # CPU: plain versions
    assert tm.training is False  # fit restored the caller's eval mode
    # evaluate: 80 = 2 x 32 + 16, a ragged last batch.
    jlogs = jm.evaluate((x, y), verbose=0)
    tlogs = tm.evaluate((x, y), verbose=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(tlogs[key], float(jlogs[key]),
                                   err_msg=key, **TOL)
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 80, 32)]
    jpred = jm.predict(batches)
    tpred = tm.predict(batches)
    assert tpred.shape == (80, 10) and tpred.dtype == np.float32
    np.testing.assert_allclose(tpred, np.asarray(jpred), **TOL)
    with torch.no_grad():
        eval_fwd = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tpred, eval_fwd, **TOL)
    np.testing.assert_allclose(tm.predict(x), eval_fwd, **TOL)


# -- full width: trees and summaries -------------------------------------------------


def _reference_tree(jm):
    spec = jax.eval_shape(lambda k: jm.init(k), jax.random.PRNGKey(0))
    return {name: tuple(t.shape) for name, t in variables_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               spec)).items()}


@pytest.mark.parametrize("name,shape,count,leaves", [
    ("ResNet18", (28, 28, 1), 11_172_810, 62),
    ("ResNet50", (32, 32, 3), 23_520_842, 161),
])
def test_full_width_resnets_have_the_references_tree(name, shape, count,
                                                      leaves):
    tm = getattr(resnet, name)(input_shape=shape)
    jm = getattr(jresnet, name)(input_shape=shape)
    want = _reference_tree(jm)
    got = {n: tuple(t.shape) for n, t in tm.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == count
    assert len(list(tm.parameters())) == leaves
    assert tm.training is False


def _summary(model):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        text = model.summary()
    assert out.getvalue() == text + "\n"
    return text


@pytest.mark.parametrize("which", ["cnn", "resnet18", "resnet50",
                                   "no_input_shape"])
def test_summary_is_the_references_text(which):
    if which == "cnn":
        pair = jcnn.build_cnn_model(), cnn.build_cnn_model()
    elif which == "resnet18":
        pair = (jresnet.ResNet18(input_shape=(28, 28, 1)),
                resnet.ResNet18(input_shape=(28, 28, 1)))
    elif which == "resnet50":
        pair = (jresnet.ResNet50(input_shape=(32, 32, 3)),
                resnet.ResNet50(input_shape=(32, 32, 3)))
    else:
        pair = (jmodel_lib.Sequential([jlayers.Conv2D(4, 3),
                                       jlayers.BatchNormalization(),
                                       jlayers.ReLU(), jlayers.Flatten(),
                                       jlayers.Dense(2)]),
                Sequential([layers.Conv2D(4, 3), layers.BatchNormalization(),
                            layers.ReLU(), layers.Flatten(),
                            layers.Dense(2)]))
    want, got = _summary(pair[0]), _summary(pair[1])
    assert got == want
    if which.startswith("resnet"):
        assert "Non-trainable state:" in got
    # summary() allocated nothing and left the model's tensors as they were.
    assert all(p.device.type == "cpu" for p in pair[1].parameters())
