"""The port's MNIST CNN and its layers against the reference's, on the CPU.

The reference's layers and CNN get their weights from ``init`` and the
port's load them through ``models/bridge.py`` (Conv2D kernels keep the
reference's HWIO layout). The same NHWC inputs, made with numpy from a
seed, go through both. Outputs agree at atol 1e-5 (fp32 on both sides;
the reference's CPU stem convolution is an im2col matmul, so sums run in
another order). The CNN ``fit`` runs fused CE + fused SGD (lr 0.01) for 2
epochs x 5 steps over batches of 32 of the synthetic MNIST both packages
load; per-epoch losses and final parameters agree at atol 1e-5. The
reference's CPU max-pool splits the gradient between tied maxima where
PyTorch's routes it to one; the ties there are zeros after ReLU, whose
gradient is zero either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.data import sources as jsources
from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import Dataset, load_arrays
from tpu_dist_torch.models import cnn, layers
from tpu_dist_torch.models.bridge import params_from_jax
from tpu_dist_torch.ops import fused, losses, metrics
from tpu_dist_torch.ops import optimizers as opt

TOL = dict(atol=1e-5, rtol=1e-5)


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _apply_pair(jlayer, layer, in_shape, seed):
    """The reference layer and the port's on the same input and weights."""
    params, _, jshape = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    shape = layer.init(torch.Generator().manual_seed(0), in_shape)
    assert tuple(shape) == tuple(jshape)
    if params:
        layer.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
    x = _images((3, *in_shape), seed)
    want, _ = jlayer.apply(params, {}, jnp.asarray(x))
    got = layer(torch.from_numpy(x))
    assert got.shape == want.shape
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("padding,strides,in_shape", [
    ("valid", 1, (28, 28, 1)), ("valid", 1, (13, 13, 32)),
    ("same", 1, (9, 9, 4)), ("same", 2, (9, 10, 3)), ("valid", 2, (9, 9, 3)),
])
def test_conv2d_matches_reference(padding, strides, in_shape):
    got, want = _apply_pair(
        jlayers.Conv2D(8, 3, strides=strides, padding=padding,
                       activation="relu"),
        layers.Conv2D(8, 3, strides=strides, padding=padding,
                      activation="relu"), in_shape, seed=1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("padding,pool,strides,in_shape", [
    ("valid", 2, None, (26, 26, 32)), ("valid", 2, None, (11, 11, 64)),
    ("same", 2, None, (7, 7, 3)), ("valid", 3, 2, (9, 9, 2)),
    ("same", 3, 2, (8, 8, 2)),
])
def test_maxpool_matches_reference(padding, pool, strides, in_shape):
    got, want = _apply_pair(
        jlayers.MaxPooling2D(pool, strides=strides, padding=padding),
        layers.MaxPooling2D(pool, strides=strides, padding=padding),
        in_shape, seed=2)
    np.testing.assert_array_equal(got, want)


def test_flatten_keeps_nhwc_order():
    got, want = _apply_pair(jlayers.Flatten(), layers.Flatten(), (5, 5, 4),
                            seed=3)
    np.testing.assert_array_equal(got, want)


def _cnn_pair():
    jmodel = jcnn.build_cnn_model()
    variables = jmodel.init(0)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = cnn.build_cnn_model()
    model.load_jax_params(params)
    return jmodel, model, variables


def test_cnn_forward_matches_reference():
    jmodel, model, variables = _cnn_pair()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert sum(p.numel() for p in model.parameters()) == 225_034
    assert len(list(model.parameters())) == 8
    assert sorted(model.state_dict()) == sorted(params_from_jax(params))
    x = _images((4, 28, 28, 1), seed=4)
    want = jmodel(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_cnn_fused_fit_matches_reference():
    jmodel, model, _ = _cnn_pair()
    images, labels = load_arrays("mnist")
    jimages, jlabels = jsources.load_arrays("mnist")
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)
    x = images[:320].astype(np.float32) / 255.0
    y = labels[:320]
    jmodel.compile(
        optimizer=jopt.SGD(learning_rate=0.01, fused=True),
        loss=jlosses.SparseCategoricalCrossentropy(from_logits=True,
                                                   fused=True),
        metrics=[jmetrics.SparseCategoricalAccuracy()])
    model.compile(
        optimizer=opt.SGD(learning_rate=0.01, fused=True),
        loss=losses.SparseCategoricalCrossentropy(from_logits=True,
                                                  fused=True),
        metrics=[metrics.SparseCategoricalAccuracy()], device="cpu")
    counts = (fused.fused_ce_fwd.launches, fused.fused_ce_bwd.launches,
              fused.fused_sgd_apply.launches)
    jh = jmodel.fit((x, y), epochs=2, steps_per_epoch=5, verbose=0).history
    th = model.fit(Dataset.from_tensor_slices((x, y)).batch(32), epochs=2,
                   steps_per_epoch=5, verbose=0).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(th[key], [float(v) for v in jh[key]],
                                   err_msg=key, **TOL)
    assert th["loss"][1] < th["loss"][0]
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.variables["params"]))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    # On the CPU the kernels' plain versions ran: no launch is counted.
    assert (fused.fused_ce_fwd.launches, fused.fused_ce_bwd.launches,
            fused.fused_sgd_apply.launches) == counts
