"""``steps_per_execution = k`` of the port against k = 1 and the reference.

The models are ``test_torch_training``'s pair (the reference's LM and the
port's on the same weights). ``make_train_function(k)`` takes k stacked
batches and returns their mean loss, as the reference's scanned step does:
losses and parameters agree at ``test_torch_training``'s 2e-5. ``fit`` at
k in {2, 3} gives the History and parameters of k = 1 exactly (on the CPU
the k steps run one after another, the same operations in the same
order) and the reference's at 2e-5, over windows that stack, a single
step at the end of an epoch, and windows whose batches cannot stack (a
``drop_remainder=False`` tail), which run step by step. Batch hooks fire
once per execution with its loss, at the execution's last step, and the
progress bar advances by k.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_dist.models import transformer as jtr
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist.training.callbacks import Callback as JCallback
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.ops import losses, metrics
from tpu_dist_torch.ops import optimizers as opt
from tpu_dist_torch.training import Callback

from test_torch_training import OPTIMIZERS, TOL, _assert_params_close, \
    _tokens

VOCAB, SEQ = 64, 16


def _compiled(make_opt, k, *, reference=False):
    jmodel = jtr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                      num_heads=2)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(0)["params"])
    if reference:
        jmodel.compile(optimizer=make_opt(jopt),
                       loss=jlosses.SparseCategoricalCrossentropy(
                           from_logits=True),
                       metrics=[jmetrics.SparseCategoricalAccuracy()],
                       steps_per_execution=k)
        return jmodel
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                    num_heads=2)
    model.load_jax_params(params)
    model.compile(optimizer=make_opt(opt),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                  metrics=[metrics.SparseCategoricalAccuracy()],
                  steps_per_execution=k, device="cpu")
    return model


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_k_step_function_matches_reference_scan(optimizer):
    k = 3
    jmodel = _compiled(OPTIMIZERS[optimizer], 1, reference=True)
    model = _compiled(OPTIMIZERS[optimizer], 1)
    jfn, jstate = jmodel.make_train_function(k), jmodel.train_state()
    fn, state = model.make_train_function(k), model.train_state()
    got, want = [], []
    for i in range(2):
        batches = [_tokens(4, seed=10 * i + j) for j in range(k)]
        xs = np.stack([x for x, _ in batches])
        ys = np.stack([y for _, y in batches])
        rngs = jax.random.split(jax.random.PRNGKey(i), k)
        loss, *jstate, _health = jfn(*jstate, xs, ys, rngs)
        want.append(float(loss))
        loss = fn(*state, xs, ys)
        assert loss.shape == () and not loss.requires_grad
        got.append(float(loss))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params_close(model, jstate[0], steps=2 * k)
    # The accumulator counted every step, as the reference's.
    np.testing.assert_allclose(state[4].numpy(),
                               [float(jstate[4][0]), float(jstate[4][1])],
                               **TOL)


def test_k_step_function_is_k_single_steps():
    """The k-mean of k = 1's losses and its parameters, bit for bit."""
    one, many = (_compiled(OPTIMIZERS["adam_fused"], 1) for _ in range(2))
    fn1, st1 = one.make_train_function(), one.train_state()
    fnk, stk = many.make_train_function(2), many.train_state()
    batches = [_tokens(4, seed=j) for j in range(4)]
    singles = [fn1(*st1, x, y) for x, y in batches]
    pairs = [fnk(*stk, np.stack([batches[i][0], batches[i + 1][0]]),
                 np.stack([batches[i][1], batches[i + 1][1]]))
             for i in (0, 2)]
    for pair, i in zip(pairs, (0, 2)):
        assert torch.equal(pair, torch.stack(singles[i:i + 2]).mean())
    for a, b in zip(one.parameters(), many.parameters()):
        assert torch.equal(a, b)


def _hooks(cls):
    class Record(cls):
        wants_batches = True

        def __init__(self):
            self.seen = []

        def on_batch_end(self, step, logs):
            self.seen.append((step, float(logs["loss"])))

    return Record()


@pytest.mark.parametrize("optimizer,k", [("adam_fused", 2), ("sgd", 3)])
def test_fit_matches_k1_and_reference(optimizer, k):
    # 112 rows = batches of 32, 32, 32, 16. Three steps an epoch: at k = 2
    # a stacked pair and a single step, then a pair that cannot stack (16
    # and 32 rows, across the iterator's re-creation) and a single; at
    # k = 3 a stacked window, then one that cannot stack.
    x, y = _tokens(112, seed=10)
    xv, yv = _tokens(40, seed=11)
    kw = dict(epochs=2, steps_per_epoch=3, verbose=0,
              validation_data=(xv, yv))
    jmodel = _compiled(OPTIMIZERS[optimizer], k, reference=True)
    base, model = (_compiled(OPTIMIZERS[optimizer], n) for n in (1, k))
    jhook, hook = _hooks(JCallback), _hooks(Callback)
    jh = jmodel.fit((x, y), callbacks=[jhook], **kw).history
    bh = base.fit((x, y), **kw).history
    th = model.fit((x, y), callbacks=[hook], **kw).history
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        assert th[key] == bh[key], key
        np.testing.assert_allclose(th[key], [float(v) for v in jh[key]],
                                   err_msg=key, **TOL)
    for a, b in zip(model.parameters(), base.parameters()):
        assert torch.equal(a, b)
    _assert_params_close(model, jmodel.variables["params"], steps=6)
    # Once per execution, at its last step, with its loss.
    assert [s for s, _ in hook.seen] == [s for s, _ in jhook.seen]
    assert [s for s, _ in hook.seen] == (
        [1, 2, 1, 2] if k == 2 else [2, 2])
    np.testing.assert_allclose([v for _, v in hook.seen],
                               [v for _, v in jhook.seen], **TOL)


def test_unstackable_tail_runs_step_by_step():
    """The reference's ragged multi-step case: 80 rows in batches of 32,
    32 and 16 at k = 3 — every epoch's one window cannot stack."""
    x, y = _tokens(80, seed=14)
    jmodel = _compiled(OPTIMIZERS["sgd"], 3, reference=True)
    base, model = (_compiled(OPTIMIZERS["sgd"], n) for n in (1, 3))
    jh = jmodel.fit((x, y), epochs=2, verbose=0).history
    bh = base.fit((x, y), epochs=2, verbose=0).history
    th = model.fit((x, y), epochs=2, verbose=0).history
    assert len(th["loss"]) == 2 and th["loss"] == bh["loss"]
    assert all(np.isfinite(th["loss"]))
    np.testing.assert_allclose(th["loss"], [float(v) for v in jh["loss"]],
                               **TOL)
    _assert_params_close(model, jmodel.variables["params"], steps=6)


def test_batch_hooks_fire_once_per_execution_and_bar_advances_by_k(capsys):
    x, y = _tokens(128, seed=15)
    base, model = (_compiled(OPTIMIZERS["sgd"], n) for n in (1, 2))
    one, two = _hooks(Callback), _hooks(Callback)
    base.fit((x, y), epochs=1, verbose=0, callbacks=[one])
    model.fit((x, y), epochs=1, verbose=1, callbacks=[two])
    assert [s for s, _ in one.seen] == [0, 1, 2, 3]
    assert [s for s, _ in two.seen] == [1, 3]
    # Each execution's loss is the mean of its two steps'.
    singles = [v for _, v in one.seen]
    np.testing.assert_allclose([v for _, v in two.seen],
                               [np.float32(singles[i] + singles[i + 1]) / 2
                                for i in (0, 2)], rtol=1e-6)
    out = capsys.readouterr().out
    assert "2/4" in out and "4/4" in out and "1/4" not in out


def test_compile_accepts_steps_per_execution():
    model = _compiled(OPTIMIZERS["sgd"], 4)
    assert model.steps_per_execution == 4
    with pytest.raises(ValueError, match="steps_per_execution"):
        model.compile(optimizer="sgd", loss="mse", steps_per_execution=0,
                      device="cpu")
