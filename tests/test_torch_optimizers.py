"""The port's optimizers and schedules against the reference's.

The same parameter tree and per-step gradients, made with numpy from a
seed, go through ``tpu_dist.ops.optimizers`` (pure updates, threaded
state) and ``tpu_dist_torch.ops.optimizers`` (in-place updates over the
tree's leaves in ``jax.tree_util.tree_leaves`` order) for several steps.
Both do the same fp32 arithmetic elementwise; params and state agree at
1e-6 (XLA may contract a multiply-add into one rounding where PyTorch
rounds twice). The fused Adam kernel's plain version is held to the
reference's Pallas ``_adam_kernel`` in interpret mode (fused SGD's to its
kernels in ``test_torch_fused_sgd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import optimizers as jopt
from tpu_dist.ops import pallas_kernels as jpk
from tpu_dist.ops import schedules as jsched
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops import optimizers as opt
from tpu_dist_torch.ops import schedules as sched

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"b": (5,), "w": (3, 4), "z": (2, 3, 2)}
STEPS = 4


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaves(tree):
    return [torch.from_numpy(np.array(a)) for a in
            jax.tree_util.tree_leaves(tree)]


def _assert_tree_close(tensors, tree):
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    assert len(tensors) == len(want)
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.numpy(), w, **TOL)


def _run_both(make, seed=0):
    """STEPS updates of the same tree by both packages; returns the port's
    params and state and the reference's."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jo, to = make(jopt), make(opt)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jo.init(jparams)
    tparams = _leaves(params)
    tstate = to.init(tparams)
    for _ in range(STEPS):
        grads = _tree(rng, scale=3.0)  # large enough for the clips to bite
        jparams, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray,
                                                           grads),
                                    jstate, jparams)
        tstate = to.update(_leaves(grads), tstate, tparams)
    return tparams, tstate, jparams, jstate


CASES = {
    "sgd": lambda m: m.SGD(learning_rate=0.05),
    "sgd_momentum": lambda m: m.SGD(learning_rate=0.05, momentum=0.9),
    "sgd_nesterov": lambda m: m.SGD(learning_rate=0.05, momentum=0.9,
                                    nesterov=True),
    "sgd_clipnorm": lambda m: m.SGD(learning_rate=0.05, clipnorm=1.0),
    "sgd_clipvalue": lambda m: m.SGD(learning_rate=0.05, clipvalue=0.5),
    "sgd_global_clipnorm": lambda m: m.SGD(learning_rate=0.05,
                                           global_clipnorm=2.0),
    "sgd_fused": lambda m: m.SGD(learning_rate=0.05, fused=True),
    "sgd_fused_nesterov": lambda m: m.SGD(learning_rate=0.05, momentum=0.9,
                                          nesterov=True, fused=True),
    "sgd_fused_schedule": lambda m: m.SGD(
        learning_rate=(jsched if m is jopt else sched).ExponentialDecay(
            0.1, decay_steps=2, decay_rate=0.5),
        momentum=0.5, fused=True),
    "sgd_schedule": lambda m: m.SGD(
        learning_rate=(jsched if m is jopt else sched).ExponentialDecay(
            0.1, decay_steps=2, decay_rate=0.5),
        momentum=0.5),
    "adam": lambda m: m.Adam(learning_rate=0.01),
    "adam_fused": lambda m: m.Adam(learning_rate=0.01, fused=True),
    "adam_schedule_clip": lambda m: m.Adam(
        learning_rate=(jsched if m is jopt else sched).CosineDecay(
            0.01, decay_steps=3), global_clipnorm=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    tparams, tstate, jparams, jstate = _run_both(CASES[case])
    _assert_tree_close(tparams, jparams)
    if isinstance(jstate, jopt.AdamState):
        assert int(tstate.step) == int(jstate.step) == STEPS
        _assert_tree_close(tstate.mu, jstate.mu)
        _assert_tree_close(tstate.nu, jstate.nu)
    elif isinstance(jstate, jopt.SGDState):
        assert int(tstate.step) == int(jstate.step) == STEPS
        _assert_tree_close(tstate.velocity, jstate.velocity)
    elif jstate == ():
        assert tstate == ()
    else:
        _assert_tree_close(tstate, jstate)


def test_fused_adam_plain_matches_reference_kernel_interpret():
    # The reference's Pallas _adam_kernel over its packed (rows, 128)
    # buffer, in the interpreter, against the port's plain version leaf by
    # leaf: the same fp32 elementwise arithmetic. The port's version takes
    # the step count and the rate and derives the reference's scale.
    rng = np.random.default_rng(1)
    p, g = _tree(rng), _tree(rng)
    m = jax.tree_util.tree_map(lambda a: 0.1 * np.abs(a), _tree(rng))
    v = jax.tree_util.tree_map(np.square, _tree(rng))
    t, lr = 3, 0.003
    scale = np.float32(lr * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t))
    jp, jm, jv = jpk.fused_adam_apply(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (p, g, m, v)),
        scale=jnp.asarray(scale), interpret=True)
    tp, tm, tv = (_leaves(t) for t in (p, m, v))
    step = torch.tensor(t, dtype=torch.int32)
    before = fused.fused_adam_apply.launches
    fused.fused_adam_plain(tp, _leaves(g), tm, tv, step=step,
                           learning_rate=lr)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        _assert_tree_close(got, want)
    # The wrapper on CPU tensors is the plain version and counts nothing.
    tp2, tm2, tv2 = (_leaves(t) for t in (p, m, v))
    fused.fused_adam_apply(tp2, _leaves(g), tm2, tv2, step=step,
                           learning_rate=lr)
    assert all(torch.equal(a, b) for a, b in zip(tp + tm + tv,
                                                 tp2 + tm2 + tv2))
    assert fused.fused_adam_apply.launches == before


def test_sgd_fused_on_cpu_matches_reference():
    # SGD(fused=True) is ported now: on CPU parameters it takes the fused
    # kernel's plain version and matches the reference's SGD(fused=True).
    tparams, tstate, jparams, jstate = _run_both(
        lambda m: m.SGD(learning_rate=0.05, momentum=0.9, fused=True))
    assert opt.SGD(fused=True).fused
    _assert_tree_close(tparams, jparams)
    _assert_tree_close(tstate, jstate)


@pytest.mark.parametrize("case", ["sgd_fused", "sgd_fused_nesterov",
                                  "sgd_fused_schedule", "adam_fused"])
def test_fused_optimizer_state_keeps_the_reference_tree(case):
    # The leaf table lives on the optimizer, beside the state: the state
    # keeps the reference's shape (the same NamedTuple fields, or a velocity
    # list in the reference tree's leaf order), with tensors as its only
    # leaves.
    _, tstate, _, jstate = _run_both(CASES[case])
    tleaves = jax.tree_util.tree_leaves(tstate, is_leaf=torch.is_tensor)
    jleaves = jax.tree_util.tree_leaves(jstate)
    if hasattr(jstate, "_fields"):
        assert type(tstate).__name__ == type(jstate).__name__
        assert tstate._fields == jstate._fields
    elif jstate == ():
        assert tstate == ()
    else:
        assert isinstance(tstate, list)
    assert len(tleaves) == len(jleaves)
    assert all(torch.is_tensor(t) for t in tleaves)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]


def test_optimizer_arguments_are_checked_as_in_the_reference():
    with pytest.raises(ValueError, match="at most one"):
        opt.SGD(clipnorm=1.0, clipvalue=1.0)
    with pytest.raises(ValueError, match="must be > 0"):
        opt.Adam(clipnorm=0.0)
    assert isinstance(opt.get("adam"), opt.Adam)
    assert isinstance(opt.get("SGD"), opt.SGD)
    assert opt.Adam().epsilon == 1e-7  # Keras's, not PyTorch's 1e-8
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get("rmsprop")


SCHEDULES = {
    "exponential": lambda m: m.ExponentialDecay(0.1, 3, 0.5),
    "exponential_staircase": lambda m: m.ExponentialDecay(0.1, 3, 0.5,
                                                          staircase=True),
    "cosine": lambda m: m.CosineDecay(0.2, 5, alpha=0.1),
    "piecewise": lambda m: m.PiecewiseConstantDecay([2, 5], [1.0, 0.5, 0.1]),
    "warmup_cosine": lambda m: m.WarmupCosine(0.3, 3, 6, alpha=0.05),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    js, ts = SCHEDULES[name](jsched), SCHEDULES[name](sched)
    steps = list(range(12))
    want = [float(js(jnp.asarray(s, jnp.int32))) for s in steps]
    got = [float(ts(torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    assert sched.resolve(ts) == (ts, True)
    assert sched.resolve(0.5) == (0.5, False)


def test_piecewise_schedule_rejects_bad_lengths():
    with pytest.raises(ValueError, match="len"):
        sched.PiecewiseConstantDecay([1, 2], [1.0])
