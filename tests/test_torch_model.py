"""The port's ``Model`` container, Dropout, train/eval modes and the
compute policy in the programs' identity, on the CPU.

A functional ``Model(init_fn, apply_fn)`` with a state counter trains in
both packages from the same (bridged) variables on the same batches:
losses and parameters agree at atol = rtol = 1e-5 (fp32, sums in another
order) and the counter exactly. Dropout's masks cannot match across RNGs
(JAX's threefry against PyTorch's generators), so its keep rate, its
``1 / keep`` scale, its identity in eval mode, its determinism under one
seed and its fresh masks from step to step are tested instead.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models import model as jmodel_lib
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import Model, Sequential, layers
from tpu_dist_torch.models.bridge import variables_from_jax
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.training.trainer import Trainer

tpolicy = importlib.import_module("tpu_dist_torch.models.policy")

TOL = dict(atol=1e-5, rtol=1e-5)


def _jinit(key, shape):
    return ({"dense": {"kernel": 0.3 * jax.random.normal(key,
                                                         (shape[-1], 4)),
                       "bias": jnp.zeros(4)}},
            {"count": jnp.zeros((), jnp.float32)})


def _japply(params, state, x, training, rng):
    y = x @ params["dense"]["kernel"] + params["dense"]["bias"]
    return y, ({"count": state["count"] + 1.0} if training else state)


def _tinit(gen, shape):
    return ({"dense": {"kernel": 0.3 * torch.randn(shape[-1], 4,
                                                   generator=gen),
                       "bias": torch.zeros(4)}},
            {"count": torch.zeros(())})


def _tapply(params, state, x, training, rng):
    y = x @ params["dense"]["kernel"] + params["dense"]["bias"]
    return y, ({"count": state["count"] + 1.0} if training else state)


def test_functional_model_trains_as_the_reference():
    jm = jmodel_lib.Model(_jinit, _japply, input_shape=(5,), name="counter")
    variables = jax.tree_util.tree_map(np.asarray, jm.init(0))
    tm = Model(_tinit, _tapply, input_shape=(5,), name="counter")
    assert sorted(tm.state_dict()) == ["count", "dense.bias",
                                       "dense.kernel"]
    tm.load_jax_variables(variables)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 5)).astype(np.float32)
    y = rng.integers(0, 4, 96)
    jm.compile(optimizer=jopt.SGD(learning_rate=0.1),
               loss=jlosses.SparseCategoricalCrossentropy(from_logits=True))
    tm.compile(optimizer=optimizers.SGD(learning_rate=0.1),
               loss=losses.SparseCategoricalCrossentropy(from_logits=True),
               device="cpu")
    jh = jm.fit((x, y), epochs=1, steps_per_epoch=3, verbose=0).history
    th = tm.fit(Dataset.from_tensor_slices((x, y)).batch(32), epochs=1,
                steps_per_epoch=3, verbose=0).history
    np.testing.assert_allclose(th["loss"], [float(v) for v in jh["loss"]],
                               **TOL)
    want = variables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jm.variables))
    for name, value in want.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(),
                                   value.numpy(), err_msg=name, **TOL)
    assert float(tm.count) == 3.0
    # The variables' layout is the reference's tree.
    v = tm.variables
    assert set(v) == {"params", "state"}
    assert set(v["params"]["dense"]) == {"kernel", "bias"}
    assert set(v["state"]) == {"count"}
    # Eval mode (evaluate, predict) leaves the state alone.
    tm.evaluate((x, y), verbose=0)
    out = tm.predict(x[:7])
    assert out.shape == (7, 4) and float(tm.count) == 3.0
    np.testing.assert_allclose(out, np.asarray(jm.predict(x[:7])), **TOL)


def test_load_jax_variables_is_strict_on_names_and_shapes():
    tm = Model(_tinit, _tapply, input_shape=(5,))
    good = {"params": {"dense": {"kernel": np.zeros((5, 4), np.float32),
                                 "bias": np.zeros(4, np.float32)}},
            "state": {"count": np.zeros((), np.float32)}}
    tm.load_jax_variables(good)
    with pytest.raises(RuntimeError, match="count"):
        tm.load_jax_variables({"params": good["params"], "state": {}})
    bad = {"params": {"dense": {"kernel": np.zeros((4, 4), np.float32),
                                "bias": np.zeros(4, np.float32)}},
           "state": good["state"]}
    with pytest.raises(RuntimeError, match="size mismatch"):
        tm.load_jax_variables(bad)
    with pytest.raises(RuntimeError, match="missing"):
        tm.load_jax_params({"dense": {"kernel": good["params"]["dense"][
            "kernel"]}})


def _dropout_net(rate=0.5):
    return Sequential([layers.Dense(16, activation="relu"),
                       layers.Dropout(rate), layers.Dense(3)],
                      input_shape=(8,), name="dropout_net", seed=1)


def test_dropout_keep_rate_scale_and_eval_identity():
    layer = layers.Dropout(0.3)
    layer.generator = torch.Generator().manual_seed(0)
    layer.train()
    x = torch.ones(200_000)
    y = layer(x)
    kept = y != 0
    keep = kept.float().mean().item()
    # Binomial keep count: within 5 standard errors of 0.7.
    assert abs(keep - 0.7) < 5 * (0.7 * 0.3 / x.numel()) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    layer.eval()
    assert torch.equal(layer(x), x)
    layer.train()
    assert torch.equal(layers.Dropout(0.0).train()(x), x)
    with pytest.raises(ValueError, match="generator"):
        layers.Dropout(0.5).train()(x)
    for rate in (1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            layers.Dropout(rate)


def test_dropout_masks_follow_the_fit_seed_and_change_every_step():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = rng.integers(0, 3, 64)

    def fit(seed, lr=0.05):
        model = _dropout_net()
        model.compile(optimizer=optimizers.SGD(learning_rate=lr),
                      loss=losses.SparseCategoricalCrossentropy(
                          from_logits=True), device="cpu")
        h = model.fit(Dataset.from_tensor_slices((x, y)).batch(32),
                      epochs=2, steps_per_epoch=2, seed=seed,
                      verbose=0).history
        return h["loss"], model

    a, ma = fit(3)
    b, _ = fit(3)
    c, _ = fit(4)
    assert a == b and a != c
    # lr 0: the weights never move, so only the masks change the loss; the
    # same batch twice gives two masks.
    model = _dropout_net()
    model.compile(optimizer=optimizers.SGD(learning_rate=0.0),
                  loss=losses.SparseCategoricalCrossentropy(
                      from_logits=True), device="cpu")
    fn, state = model.make_train_function(), model.train_state()
    first = float(fn(*state, x[:32], y[:32]))
    second = float(fn(*state, x[:32], y[:32]))
    assert first != second
    # Eval mode draws nothing: predict is deterministic.
    np.testing.assert_array_equal(ma.predict(x), ma.predict(x))


def test_trainer_sets_the_mode_and_restores_the_callers():
    model = _dropout_net(0.0)
    assert model.training is False           # built in eval mode
    model.compile(optimizer="sgd",
                  loss=losses.SparseCategoricalCrossentropy(
                      from_logits=True), device="cpu")
    seen = []
    hook = model.dense.register_forward_hook(
        lambda m, i, o: seen.append(m.training))
    x = np.zeros((32, 8), np.float32)
    y = np.zeros(32, np.int64)
    model.fit((x, y), epochs=1, steps_per_epoch=1, verbose=0)
    assert seen == [True] and model.training is False
    model.train()
    model.evaluate((x, y), verbose=0)
    model.predict(x)
    assert seen == [True, False, False] and model.training is True
    hook.remove()


def test_policy_is_part_of_the_program_keys():
    before = tpolicy.policy()
    try:
        tpolicy.set_policy("float32")
        train32 = Trainer._train_variant(None, None)
        eval32 = Trainer._eval_variant(None)
        tpolicy.set_policy("mixed_bfloat16")
        train16 = Trainer._train_variant(None, None)
        eval16 = Trainer._eval_variant(None)
    finally:
        tpolicy.set_policy(before)
    assert train32 != train16 and eval32 != eval16
    assert train32[0] == eval32[0] == "float32"
    assert train16[0] == eval16[0] == "mixed_bfloat16"


def test_fit_after_set_policy_runs_the_bf16_step():
    from tpu_dist_torch.models import resnet

    model = Sequential([*resnet._conv_bn(4, 3), layers.Flatten(),
                        layers.Dense(3)], input_shape=(6, 6, 1), name="p")
    model.compile(optimizer=optimizers.SGD(learning_rate=0.01),
                  loss=losses.SparseCategoricalCrossentropy(
                      from_logits=True), device="cpu")
    seen = []
    model.conv2d.register_forward_hook(
        lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    x = np.random.default_rng(0).standard_normal((32, 6, 6, 1)).astype(
        np.float32)
    y = np.zeros(32, np.int64)
    model.fit((x, y), epochs=1, steps_per_epoch=1, verbose=0)
    before = tpolicy.policy()
    try:
        tpolicy.set_policy("mixed_bfloat16")
        h = model.fit((x, y), epochs=1, steps_per_epoch=1, verbose=0)
        out = model.predict(x)
    finally:
        tpolicy.set_policy(before)
    assert seen[0] == (torch.float32, torch.float32)
    assert seen[1] == (torch.bfloat16, torch.bfloat16)
    assert np.isfinite(h.history["loss"]).all() and out.dtype == np.float32
    assert model.batchnormalization.mean.dtype == torch.float32
