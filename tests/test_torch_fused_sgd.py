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

import gc
import weakref

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


# -- the leaf table cache, on the CPU (device index -1, nothing launches) ----


def _table_leaves(momentum=False, seed=9):
    rng = np.random.default_rng(seed)
    params = _leaves(_tree(rng))
    # A view that starts 4 bytes past its storage: not on a 16-byte boundary.
    params.append(torch.from_numpy(rng.standard_normal(41).astype(
        np.float32))[1:])
    params.append(torch.zeros(0))       # an empty leaf takes no row
    grads = [torch.ones_like(p) for p in params]
    vel = [torch.zeros_like(p) for p in params] if momentum else None
    return params, grads, vel


def _rows(t, width):
    """The table's rows as int64 tuples (``width`` addresses, then the
    grad's index, the length, the first chunk and the alignment flag) and
    its chunk -> row map."""
    cols = width + 4
    head = t.table[:2 * cols * t.rows].view(torch.int64).reshape(t.rows, cols)
    return [tuple(r) for r in head.tolist()], t.table[2 * cols * t.rows:]


@pytest.mark.parametrize("momentum", [False, True])
def test_leaf_table_is_built_once_over_repeated_calls(momentum):
    params, grads, vel = _table_leaves(momentum)
    tables = fused.sgd_tables()
    state = (vel,) if vel else ()
    first = tables.get(-1, params, grads, state)
    for _ in range(3):
        assert tables.get(-1, params, grads, state) is first
    assert tables.builds == 1
    rows, chunk_row = _rows(first, 2)
    at = [i for i, p in enumerate(params) if p.numel()]
    assert first.rows == len(rows) == len(at)
    chunks = [-(-params[i].numel() // fused.CHUNK) for i in at]
    assert first.chunks == sum(chunks)
    assert chunk_row.tolist() == [r for r, c in enumerate(chunks)
                                  for _ in range(c)]
    for r, (row, i) in enumerate(zip(rows, at)):
        ptrs = (params[i].data_ptr(), vel[i].data_ptr() if vel else 0)
        aligned = all(a % 16 == 0 for a in ptrs if a)
        assert row == (*ptrs, i, params[i].numel(), sum(chunks[:r]),
                       int(aligned))
    assert rows[-1][-1] == 0          # the view off a 16-byte boundary


def test_leaf_table_outlives_grads_that_move():
    # backward hands out new grads every step: the grads' addresses go with
    # each launch, not in the table, so a grad that moves builds nothing.
    params, grads, _ = _table_leaves()
    tables = fused.sgd_tables()
    first = tables.get(-1, params, grads)
    for _ in range(3):
        grads = [g.clone() for g in grads]
        assert tables.get(-1, params, grads) is first
    assert tables.builds == 1
    ptrs = fused._grad_pointers(grads)
    assert list(ptrs) == [g.data_ptr() for g in grads]


def test_leaf_table_is_rebuilt_when_a_param_or_state_tensor_changes():
    params, grads, vel = _table_leaves(momentum=True)
    tables = fused.sgd_tables()
    first = tables.get(-1, params, grads, (vel,))
    params[0] = params[0].clone()     # another tensor, at a new address
    second = tables.get(-1, params, grads, (vel,))
    assert second is not first and tables.builds == 2
    assert _rows(second, 2)[0][0][0] == params[0].data_ptr()
    vel = [v.clone() for v in vel]    # a new optimizer state
    assert tables.get(-1, params, grads, (vel,)) is not second
    assert tables.builds == 3
    # The same addresses through other tensor objects (views) miss too.
    views = [p.view(p.shape) for p in params]
    assert tables.get(-1, views, grads, (vel,)) is not None
    assert tables.builds == 4


def _bad_grads(grads, kind):
    """A grad for leaf 1 at the same address, with what the kernel refuses."""
    g = grads[1]                      # [32, 64]
    bad = {"shape": g.view(-1),
           "dtype": g.view(torch.int32),
           "contiguity": g.as_strided(g.shape, (1, g.shape[0]))}[kind]
    out = list(grads)
    out[1] = bad
    return out


@pytest.mark.parametrize("kind,match", [
    ("shape", "does not match its param"), ("dtype", "fp32"),
    ("contiguity", "non-contiguous")])
@pytest.mark.parametrize("cached", [True, False], ids=["hit", "miss"])
def test_leaf_table_refuses_a_bad_grad(kind, match, cached):
    # On the hit path the bad grad shares the cached grad's address (a view
    # of it), so only the per-call checks can catch it; on the miss path no
    # table was built yet.
    params, grads, _ = _table_leaves()
    tables = fused.sgd_tables()
    if cached:
        tables.get(-1, params, grads)
    bad = _bad_grads(grads, kind)
    assert bad[1].data_ptr() == grads[1].data_ptr()
    with pytest.raises(ValueError, match=match):
        tables.get(-1, params, bad)
    assert tables.builds == int(cached)


def test_adam_leaf_table_is_kept_on_the_optimizer():
    params, grads, _ = _table_leaves()
    adam = opt.Adam(learning_rate=0.01)
    mu, nu = ([torch.zeros_like(p) for p in params] for _ in range(2))
    for _ in range(3):
        assert adam._tables.get(-1, params, grads, (mu, nu)).rows == len(
            [p for p in params if p.numel()])
    assert adam._tables.builds == 1
    rows, _ = _rows(adam._tables.get(-1, params, grads, (mu, nu)), 3)
    assert rows[0][:4] == (params[0].data_ptr(), mu[0].data_ptr(),
                           nu[0].data_ptr(), 0)
    with pytest.raises(ValueError, match="mu"):
        adam._tables.get(-1, params, grads,
                         ([m.double() for m in mu], nu))


def test_leaf_table_refuses_more_leaves_than_a_launch_takes():
    # The grads' addresses ride in the launch's parameters: at most
    # MAX_LEAVES of them.
    params = [torch.zeros(1) for _ in range(fused.MAX_LEAVES + 1)]
    with pytest.raises(ValueError, match=f"at most {fused.MAX_LEAVES}"):
        fused.sgd_tables().get(-1, params, params)


def test_leaf_table_keeps_no_tensor_alive():
    # The cache holds addresses and weak references only: a dropped model's
    # params and state are freed, and its table no longer matches anything.
    params, grads, vel = _table_leaves(momentum=True)
    tables = fused.sgd_tables()
    t = tables.get(-1, params, grads, (vel,))
    refs = [weakref.ref(x) for x in params + vel]
    del params, vel
    gc.collect()
    assert all(r() is None for r in refs)
    assert t.dead()
    # The next build drops the dead table.
    params, grads, vel = _table_leaves(momentum=True, seed=10)
    assert tables.get(-1, params, grads, (vel,)) is not t
    assert list(tables._tables.values()) == [tables.get(-1, params, grads,
                                                        (vel,))]
