"""The port's losses and metrics against the reference's.

The same logits, labels and targets, made with numpy from a seed, go
through ``tpu_dist.ops.losses`` / ``metrics`` and their ports. Losses agree
at 1e-6 (fp32 on both sides, reductions in another order); metrics are
counts and agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist_torch.ops import losses, metrics

TOL = dict(atol=1e-6, rtol=1e-6)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((6, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(6, 5))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    onehot = np.eye(7, dtype=np.float32)[labels]
    preds = rng.standard_normal((6, 4)).astype(np.float32)
    targets = rng.integers(0, 2, size=(6, 4)).astype(np.float32)
    return dict(logits=logits, labels=labels, probs=probs.astype(np.float32),
                onehot=onehot, preds=preds, targets=targets,
                sigmoid=(1 / (1 + np.exp(-preds))).astype(np.float32),
                head=preds[:, :1], head_targets=targets[:, 0])


LOSSES = {
    "sparse_ce_logits": (lambda m: m.SparseCategoricalCrossentropy(
        from_logits=True), "logits", "labels"),
    "sparse_ce_probs": (lambda m: m.SparseCategoricalCrossentropy(),
                        "probs", "labels"),
    "ce_logits": (lambda m: m.CategoricalCrossentropy(from_logits=True),
                  "logits", "onehot"),
    "ce_probs": (lambda m: m.CategoricalCrossentropy(), "probs", "onehot"),
    "mse": (lambda m: m.MeanSquaredError(), "preds", "targets"),
    "mae": (lambda m: m.MeanAbsoluteError(), "preds", "targets"),
    "bce_logits": (lambda m: m.BinaryCrossentropy(from_logits=True),
                   "preds", "targets"),
    "bce_probs": (lambda m: m.BinaryCrossentropy(), "sigmoid", "targets"),
    "bce_single_logit_head": (lambda m: m.BinaryCrossentropy(
        from_logits=True), "head", "head_targets"),
    "huber": (lambda m: m.Huber(delta=0.7), "preds", "targets"),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_reference(case):
    make, a, b = LOSSES[case]
    d = _data()
    jl, tl = make(jlosses), make(losses)
    assert tl.name == jl.name
    want = jl(jnp.asarray(d[a]), jnp.asarray(d[b]))
    got = tl(torch.from_numpy(d[a]), torch.from_numpy(d[b]))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    want_per = jl.per_example(jnp.asarray(d[a]), jnp.asarray(d[b]))
    got_per = tl.per_example(torch.from_numpy(d[a]), torch.from_numpy(d[b]))
    np.testing.assert_allclose(got_per.numpy(), np.asarray(want_per), **TOL)


@pytest.mark.parametrize("name", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy", "mse",
                                  "mean_absolute_error", "binary_crossentropy",
                                  "huber"])
def test_loss_get_resolves_like_reference(name):
    jl, tl = jlosses.get(name), losses.get(name)
    assert type(tl).__name__ == type(jl).__name__
    assert getattr(tl, "from_logits", None) == getattr(jl, "from_logits",
                                                       None)


def test_loss_errors():
    # The fused CE operates on logits, as the reference's does.
    with pytest.raises(ValueError, match="from_logits=True"):
        losses.SparseCategoricalCrossentropy(fused=True)
    with pytest.raises(ValueError, match="from_logits=True"):
        jlosses.SparseCategoricalCrossentropy(fused=True)
    with pytest.raises(ValueError, match="shapes disagree"):
        losses.mean_squared_error(torch.zeros(4, 3), torch.zeros(5))
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get("hinge")


METRICS = {
    "sparse_accuracy": (lambda m: m.SparseCategoricalAccuracy(),
                        "logits", "labels"),
    "categorical_accuracy": (lambda m: m.CategoricalAccuracy(),
                             "logits", "onehot"),
    "binary_accuracy": (lambda m: m.BinaryAccuracy(threshold=0.3),
                        "sigmoid", "targets"),
    "top_k": (lambda m: m.SparseTopKCategoricalAccuracy(k=3),
              "logits", "labels"),
    "mean": (lambda m: m.Mean(), "preds", None),
    "sum": (lambda m: m.Sum(), "preds", None),
}


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_matches_reference_over_several_updates(case):
    make, a, b = METRICS[case]
    jm, tm = make(jmetrics), make(metrics)
    assert tm.name == jm.name
    jstate, tstate = jm.init(), tm.init()
    for seed in range(3):
        d = _data(seed)
        if b is None:  # streaming scalars, weighted on the last update
            value = float(d[a].mean())
            w = 2.5 if seed == 2 else None
            jstate = jm.update(jstate, value, w)
            assert tm.update(tstate, value, w) is tstate
        else:
            jstate = jm.update(jstate, jnp.asarray(d[a]), jnp.asarray(d[b]))
            tm.update(tstate, torch.from_numpy(d[a]), torch.from_numpy(d[b]))
    for key in ("total", "count"):
        assert tstate[key].dtype == torch.float32
        np.testing.assert_allclose(float(tstate[key]), float(jstate[key]),
                                   **TOL)
    np.testing.assert_allclose(float(tm.result(tstate)),
                               float(jm.result(jstate)), **TOL)


def test_metric_get_resolves_like_reference():
    for name in ("accuracy", "sparse_categorical_accuracy",
                 "categorical_accuracy", "binary_accuracy", "top_k_accuracy",
                 "sparse_top_k_categorical_accuracy"):
        jm, tm = jmetrics.get(name), metrics.get(name)
        assert (type(tm).__name__, tm.name) == (type(jm).__name__, jm.name)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.get("auc")


def test_empty_metric_result_is_zero():
    m = metrics.SparseCategoricalAccuracy()
    assert float(m.result(m.init())) == 0.0
