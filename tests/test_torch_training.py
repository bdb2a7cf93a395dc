"""The port's training slice as a whole against the reference, on the CPU.

A reference ``build_transformer_lm`` (vocab 64, L 16, d_model 32, depth 2,
2 heads) and the port's are given the same weights (the reference's
``init(0)``, which its trainer also starts from, bridged with
``load_jax_params``) and compiled the same way; the same token batches,
made with numpy from a seed, go through
``make_train_function``/``train_state``, ``fit`` and ``evaluate`` of
both. On the CPU the port runs the plain versions of its kernels (the
reference runs its dense attention). Losses, metrics and parameters agree
at 2e-5: fp32 on both sides, sums in another order, compounded over a few
steps. One exception: the attention's key bias ``bk`` has a gradient that
is zero in exact arithmetic (it shifts a whole softmax row), so each side
computes rounding noise for it, which Adam scales into steps of up to
``lr``; under Adam it is held to ``lr`` per step instead.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_dist.models import transformer as jtr
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.models.bridge import params_from_jax
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops import losses, metrics
from tpu_dist_torch.ops import optimizers as opt
from tpu_dist_torch.parallel import MirroredStrategy
from tpu_dist_torch.training.callbacks import Callback, StopTraining

VOCAB, SEQ = 64, 16
TOL = dict(atol=2e-5, rtol=2e-5)
OPTIMIZERS = {
    "sgd": lambda m: m.SGD(learning_rate=0.1),
    "adam_fused": lambda m: m.Adam(learning_rate=0.01, fused=True),
}


def _compiled_pair(make_opt):
    jmodel = jtr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                      num_heads=2)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(0)["params"])
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                    num_heads=2)
    model.load_jax_params(params)
    jmodel.compile(optimizer=make_opt(jopt),
                   loss=jlosses.SparseCategoricalCrossentropy(
                       from_logits=True),
                   metrics=[jmetrics.SparseCategoricalAccuracy()])
    model.compile(optimizer=make_opt(opt),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                  metrics=[metrics.SparseCategoricalAccuracy()],
                  device="cpu")
    return jmodel, model


def _tokens(n, seed):
    stream = np.random.default_rng(seed).integers(0, VOCAB,
                                                  size=n * SEQ + 1)
    return (stream[:-1].reshape(n, SEQ).astype(np.int32),
            stream[1:].reshape(n, SEQ).astype(np.int32))


def _assert_params_close(model, jparams, steps):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    adam = isinstance(model.optimizer, opt.Adam)
    for name in want:
        tol = TOL
        if adam and name.endswith("multiheadattention.bk"):
            tol = dict(atol=model.optimizer.learning_rate * steps, rtol=0)
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_train_steps_match_reference(optimizer):
    jmodel, model = _compiled_pair(OPTIMIZERS[optimizer])
    jfn, jstate = jmodel.make_train_function(), jmodel.train_state()
    fn, state = model.make_train_function(), model.train_state()
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches, fused.fused_adam_apply.launches)
    jlosses_, tlosses = [], []
    for i in range(3):
        x, y = _tokens(4, seed=i)
        loss, *jstate, _health = jfn(*jstate, x, y, jax.random.PRNGKey(i))
        jlosses_.append(float(loss))
        loss = fn(*state, x, y)
        assert loss.shape == () and not loss.requires_grad
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses_, **TOL)
    _assert_params_close(model, jstate[0], steps=3)
    # The loss accumulator and the metric state follow the reference's.
    np.testing.assert_allclose(state[4].numpy(),
                               [float(jstate[4][0]), float(jstate[4][1])],
                               **TOL)
    np.testing.assert_allclose(float(state[3][0]["total"]),
                               float(jstate[3][0]["total"]))
    # On the CPU the plain versions run: no kernel launch is counted.
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            fused.fused_adam_apply.launches) == counts


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_fit_and_evaluate_match_reference(optimizer):
    jmodel, model = _compiled_pair(OPTIMIZERS[optimizer])
    # 112 rows = batches of 32, 32, 32, 16: with 3 steps per epoch the
    # second epoch takes the ragged batch and then re-creates the iterator.
    x, y = _tokens(112, seed=10)
    xv, yv = _tokens(40, seed=11)
    jh = jmodel.fit((x, y), epochs=2, steps_per_epoch=3, verbose=0,
                    validation_data=(xv, yv)).history
    th = model.fit((x, y), epochs=2, steps_per_epoch=3, verbose=0,
                   validation_data=(xv, yv)).history
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        assert len(th[key]) == 2
        np.testing.assert_allclose(th[key], [float(v) for v in jh[key]],
                                   err_msg=key, **TOL)
    want = jmodel.evaluate((xv, yv), verbose=0)
    got = model.evaluate((xv, yv), verbose=0)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), err_msg=key,
                                   **TOL)
    _assert_params_close(model, jmodel.variables["params"], steps=6)


def test_class_weighted_fit_matches_reference():
    jmodel, model = _compiled_pair(OPTIMIZERS["sgd"])
    x, y = _tokens(64, seed=12)
    weights = {3: 2.0, 7: 0.5, 60: 3.0}
    jh = jmodel.fit((x, y), epochs=1, verbose=0, class_weight=weights)
    th = model.fit((x, y), epochs=1, verbose=0, class_weight=weights)
    np.testing.assert_allclose(th.history["loss"],
                               [float(v) for v in jh.history["loss"]], **TOL)
    _assert_params_close(model, jmodel.variables["params"], steps=2)


def test_callbacks_see_batches_and_can_stop_training(capsys):
    _, model = _compiled_pair(OPTIMIZERS["sgd"])
    seen = []

    class Stop(Callback):
        wants_batches = True

        def on_batch_end(self, step, logs):
            seen.append((step, logs["loss"]))

        def on_epoch_end(self, epoch, logs):
            if epoch == 1:
                raise StopTraining("enough")

    x, y = _tokens(64, seed=13)
    history = model.fit((x, y), epochs=5, verbose=1, callbacks=[Stop()])
    assert history.epoch == [0, 1]
    assert [s for s, _ in seen] == [0, 1, 0, 1]
    assert all(np.isfinite(v) for _, v in seen)
    out = capsys.readouterr().out
    assert "Epoch 1/5" in out and "2/2" in out


def test_gradient_bucket_bytes_fit_matches_the_references_bucketed_fit():
    # One process: the bucketed schedule's collectives are the identity,
    # as the reference's shard_map over one device is.
    jmodel, model = _compiled_pair(OPTIMIZERS["sgd"])
    with pytest.raises(ValueError, match="gradient_bucket_bytes"):
        model.compile(optimizer="sgd", loss="mse", gradient_bucket_bytes=-1,
                      device="cpu")
    jmodel.compile(optimizer=jopt.SGD(learning_rate=0.1),
                   loss=jlosses.SparseCategoricalCrossentropy(
                       from_logits=True), gradient_bucket_bytes=1024)
    model.compile(optimizer=opt.SGD(learning_rate=0.1),
                  loss=losses.SparseCategoricalCrossentropy(from_logits=True),
                  gradient_bucket_bytes=1024, device="cpu")
    x, y = _tokens(64, seed=16)
    want = jmodel.fit((x, y), epochs=2, verbose=0).history
    got = model.fit((x, y), epochs=2, verbose=0).history
    assert model.gradient_bucket_bytes == model._trainer._bucket_bytes == 1024
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    _assert_params_close(model, jmodel.variables["params"], steps=4)


def test_axis_shapes_of_the_data_axis_alone_are_accepted():
    strategy = MirroredStrategy(axis_shapes={"data": 1, "model": 1},
                                device="cpu")
    assert strategy.num_replicas_in_sync == 1
    assert dict(strategy.mesh.shape) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="data"):
        MirroredStrategy(axis_shapes={"seq": 1}, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        MirroredStrategy(axis_shapes={"data": 2}, device="cpu")
    with strategy.scope():
        _, model = _compiled_pair(OPTIMIZERS["sgd"])
    assert model.strategy is strategy
    history = model.fit(_tokens(32, 0), epochs=1, verbose=0).history
    assert np.isfinite(history["loss"]).all()


@pytest.mark.parametrize("as_dataset", [False, True],
                         ids=["arrays", "Dataset input"])
def test_fit_with_profile_dir_writes_a_trace_and_trains_alike(tmp_path,
                                                              as_dataset):
    x, y = _tokens(32, 0)
    data = (Dataset.from_tensor_slices((x, y)).batch(8) if as_dataset
            else (x, y))
    histories = []
    for profile_dir in (None, tmp_path / "p"):
        _, model = _compiled_pair(OPTIMIZERS["sgd"])
        histories.append(model.fit(data, epochs=1, verbose=0,
                                   profile_dir=profile_dir).history)
    (trace,) = (tmp_path / "p").glob("*.pt.trace.json")
    assert trace.stat().st_size > 0
    assert histories[0]["loss"] == histories[1]["loss"]


def test_fit_refuses_an_iterator_with_type_error():
    # The reference's _distribute takes a Dataset, a DistributedDataset or
    # (x, y) arrays, and raises TypeError on anything else.
    _, model = _compiled_pair(OPTIMIZERS["sgd"])
    with pytest.raises(TypeError, match="Dataset"):
        model.fit(iter([_tokens(32, 0)]))


def test_fit_on_a_dataset_matches_fit_on_arrays():
    x, y = _tokens(96, seed=15)
    histories, params = [], []
    for data in ((x, y), Dataset.from_tensor_slices((x, y)).batch(32)):
        _, model = _compiled_pair(OPTIMIZERS["sgd"])
        histories.append(model.fit(data, epochs=2, verbose=0).history)
        params.append([p.detach().clone() for p in model.parameters()])
    assert histories[0]["loss"] == histories[1]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(*params))


def test_uncompiled_model_refuses_to_train():
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                    num_heads=2)
    with pytest.raises(RuntimeError, match="compile"):
        model.fit(_tokens(32, 0))
    with pytest.raises(ValueError, match="steps_per_execution"):
        model.compile(optimizer="sgd", loss="mse", steps_per_execution=0,
                      device="cpu")


def test_compile_defaults_to_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                    num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.compile(optimizer="sgd", loss="mse")


def test_mixed_bfloat16_policy_trains_with_fp32_params():
    # ``models.policy`` is the function, as in the reference's package.
    from tpu_dist_torch.models.policy import set_policy

    _, model = _compiled_pair(OPTIMIZERS["adam_fused"])
    x, y = _tokens(4, seed=14)
    fn, state = model.make_train_function(), model.train_state()
    set_policy("mixed_bfloat16")
    try:
        losses_ = [float(fn(*state, x, y)) for _ in range(3)]
    finally:
        set_policy("float32")
    assert all(np.isfinite(losses_)) and losses_[-1] < losses_[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in state[2].mu)
