"""The port's fused SGD against the reference's Pallas kernels.

The same parameter tree (a leaf whose size is not a multiple of 1024
among them) and per-step gradients, made with numpy from a seed, go
through ``tpu_dist.ops.pallas_kernels.fused_sgd_apply(..., interpret=True)``
(``_sgd_kernel`` / ``_sgd_momentum_kernel`` over the packed buffer, in the
Pallas interpreter) and the port's ``fused_sgd_apply`` on CPU tensors, which
is its plain version, for 3 steps. Both do the same fp32 elementwise
arithmetic: atol 1e-7, rtol 1e-6 (XLA may contract a multiply-add into one
rounding where PyTorch rounds twice).
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

TOL = dict(atol=1e-7, rtol=1e-6)
#: 1500 and 3 x 7 x 5 are not multiples of 1024 (the TPU packing pads them).
SHAPES = {"a": (1500,), "b": (32, 64), "c": (3, 7, 5), "d": (10,)}
MODES = {"plain": (0.0, False), "momentum": (0.9, False),
         "nesterov": (0.9, True)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaves(tree):
    return [torch.from_numpy(np.array(a)) for a in
            jax.tree_util.tree_leaves(tree)]


def _assert_close(tensors, tree):
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    assert len(tensors) == len(want)
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.numpy(), w, **TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_sgd_matches_reference_kernels(mode):
    m, nesterov = MODES[mode]
    rng = np.random.default_rng(5)
    params = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp) if m else None
    tp = _leaves(params)
    tv = [torch.zeros_like(p) for p in tp] if m else None
    before = fused.fused_sgd_apply.launches
    for _ in range(3):
        grads = _tree(rng, scale=2.0)
        jp, jv_new = jpk.fused_sgd_apply(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), jv,
            learning_rate=0.05, momentum=m, nesterov=nesterov,
            interpret=True)
        jv = jv_new if m else None
        out = fused.fused_sgd_apply(tp, _leaves(grads), tv,
                                    learning_rate=0.05, momentum=m,
                                    nesterov=nesterov)
        assert out[0] is tp
    _assert_close(tp, jp)
    if m:
        _assert_close(tv, jv)
    # CPU leaves take the plain version: no launch is counted.
    assert fused.fused_sgd_apply.launches == before


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wrapper_on_cpu_is_the_plain_version_bit_for_bit(mode):
    m, nesterov = MODES[mode]
    rng = np.random.default_rng(6)
    p, g = _tree(rng), _tree(rng)
    a, b = _leaves(p), _leaves(p)
    va = [torch.ones_like(t) for t in a] if m else None
    vb = [torch.ones_like(t) for t in b] if m else None
    kw = dict(learning_rate=0.1, momentum=m, nesterov=nesterov)
    fused.fused_sgd_apply(a, _leaves(g), va, **kw)
    fused.fused_sgd_plain(b, _leaves(g), vb, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a + (va or []),
                                                 b + (vb or [])))


def test_sgd_fused_with_schedule_matches_reference():
    # The reference keeps a scheduled lr on its jnp path; the port's fused
    # SGD takes it too (on the card through the kernel, here on the CPU
    # through the plain version): the same update.
    def make(m, s):
        return m.SGD(learning_rate=s.ExponentialDecay(0.1, 2, 0.5),
                     momentum=0.5, fused=True)

    rng = np.random.default_rng(7)
    params = _tree(rng)
    jo, to = make(jopt, jsched), make(opt, sched)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jo.init(jparams)
    tparams = _leaves(params)
    tstate = to.init(tparams)
    for _ in range(4):
        grads = _tree(rng)
        jparams, jstate = jo.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        tstate = to.update(_leaves(grads), tstate, tparams)
    _assert_close(tparams, jparams)
    _assert_close(tstate.velocity, jstate.velocity)
    assert int(tstate.step) == int(jstate.step) == 4


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wrapper_takes_a_schedules_tensor_rate_on_cpu(mode):
    # A 0-d fp32 rate (a schedule's value) gives the float rate's update.
    m, nesterov = MODES[mode]
    rng = np.random.default_rng(8)
    p, g = _tree(rng), _tree(rng)
    a, b = _leaves(p), _leaves(p)
    va = [torch.ones_like(t) for t in a] if m else None
    vb = [torch.ones_like(t) for t in b] if m else None
    rate = sched.ExponentialDecay(0.2, 1, 0.5)(torch.tensor(1))
    before = fused.fused_sgd_apply.launches
    fused.fused_sgd_apply(a, _leaves(g), va, learning_rate=rate, momentum=m,
                          nesterov=nesterov)
    fused.fused_sgd_plain(b, _leaves(g), vb, learning_rate=0.1, momentum=m,
                          nesterov=nesterov)
    assert all(torch.equal(x, y) for x, y in zip(a + (va or []),
                                                 b + (vb or [])))
    assert fused.fused_sgd_apply.launches == before


def test_momentum_without_velocity_is_refused():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="velocity"):
        fused.fused_sgd_apply(p, [torch.ones(3)], [], learning_rate=0.1,
                              momentum=0.9)
