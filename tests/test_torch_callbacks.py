"""``EarlyStopping``, ``LambdaCallback`` and ``ModelCheckpoint`` against the
JAX package's, on the same logs (CPU).

Each pair of callbacks is driven with one sequence of epoch logs: the
epoch ``EarlyStopping`` stops at (and whether it stops), what a
``LambdaCallback`` sees, and which steps ``ModelCheckpoint`` writes under
``save_best_only`` in either mode, sync or async, must agree; so must a
``fit`` that an ``EarlyStopping`` ends.
"""

import numpy as np
import pytest

from tpu_dist.models import cnn as jcnn
from tpu_dist.models import layers as jlayers
from tpu_dist.models import model as jmodel_lib
from tpu_dist.ops import optimizers as jopt
from tpu_dist.training import callbacks as jcallbacks
from tpu_dist.training import checkpoint as jckpt
from tpu_dist_torch.models import Sequential, cnn, layers
from tpu_dist_torch.ops import optimizers
from tpu_dist_torch.training import (EarlyStopping, LambdaCallback,
                                     ModelCheckpoint, StopTraining,
                                     checkpoint)

LOSSES = [1.0, 0.8, 0.85, 0.79, 0.9, 0.95, 0.7, 0.99, 0.98, 0.97, 0.96]


def _drive(cb, stop_type, values, key="loss"):
    """Feed ``cb`` one epoch log per value; returns the epoch it stopped
    at, or None."""
    cb.on_train_begin()
    try:
        for epoch, v in enumerate(values):
            try:
                cb.on_epoch_end(epoch, {key: v, "accuracy": 1.0 - v})
            except stop_type:
                return epoch
        return None
    finally:
        cb.on_train_end()


@pytest.mark.parametrize("kw", [
    {}, {"patience": 0}, {"patience": 1, "min_delta": 0.02},
    {"monitor": "accuracy", "mode": "max", "patience": 1},
    {"monitor": "val_loss"},
], ids=["default", "patience0", "min_delta", "max_mode", "absent"])
def test_early_stopping_stops_where_the_reference_stops(kw):
    ours, ref = EarlyStopping(**kw), jcallbacks.EarlyStopping(**kw)
    got = _drive(ours, StopTraining, LOSSES)
    want = _drive(ref, jcallbacks.StopTraining, LOSSES)
    assert got == want and ours.stopped_epoch == ref.stopped_epoch
    if kw.get("monitor") != "val_loss":
        assert got is not None


def test_lambda_callback_sees_what_the_reference_sees():
    seen, jseen = [], []
    for store, mod in ((seen, None), (jseen, jcallbacks)):
        make = LambdaCallback if mod is None else mod.LambdaCallback
        cb = make(on_epoch_end=lambda e, logs, s=store: s.append(("e", e,
                                                                   logs)),
                  on_batch_end=lambda b, logs, s=store: s.append(("b", b)))
        assert cb.wants_batches
        cb.on_batch_end(0, {"loss": 1.0})
        cb.on_epoch_end(3, {"loss": 0.5})
    assert seen == jseen
    assert not LambdaCallback(on_epoch_end=print).wants_batches


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("mode, monitor", [("min", "loss"),
                                           ("max", "accuracy")])
def test_model_checkpoint_saves_the_steps_the_reference_saves(
        tmp_path, async_save, mode, monitor):
    kw = dict(save_best_only=True, monitor=monitor, mode=mode,
              async_save=async_save)
    tm = Sequential([layers.Dense(3)], input_shape=(4,), name="tiny")
    tm.compile(optimizer=optimizers.SGD(0.1), loss="mse", device="cpu")
    jm = jmodel_lib.Sequential([jlayers.Dense(3)], input_shape=(4,),
                               name="tiny")
    jm.compile(optimizer=jopt.SGD(0.1), loss="mse")
    jm.train_state()          # the reference saves live variables
    ours = ModelCheckpoint(str(tmp_path / "port"), **kw)
    ref = jcallbacks.ModelCheckpoint(str(tmp_path / "jax"), **kw)
    ours.model, ref.model = tm, jm
    _drive(ours, StopTraining, LOSSES)
    _drive(ref, jcallbacks.StopTraining, LOSSES)
    got = checkpoint.all_steps(tmp_path / "port")
    assert got == jckpt.all_steps(tmp_path / "jax")
    assert got == [0, 1, 3, 6]    # where the loss (so the accuracy) improves
    assert checkpoint.latest_step(tmp_path / "port") == 6
    # A monitor the logs lack saves nothing, as in the reference.
    absent = ModelCheckpoint(str(tmp_path / "none"), save_best_only=True,
                             monitor="val_loss", async_save=async_save)
    absent.model = tm
    _drive(absent, StopTraining, LOSSES)
    assert checkpoint.all_steps(tmp_path / "none") == []


def test_early_stopping_ends_fit_as_in_the_reference():
    rng = np.random.default_rng(0)
    x = rng.random((64, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 64)
    jm = jcnn.build_and_compile_cnn_model(learning_rate=0.0)
    tm = cnn.build_and_compile_cnn_model(learning_rate=0.0, device="cpu")
    # lr 0: the loss never improves after the first epoch.
    jh = jm.fit((x, y), epochs=10, verbose=0, callbacks=[
        jcallbacks.EarlyStopping(patience=2)]).history
    th = tm.fit((x, y), epochs=10, verbose=0, callbacks=[
        EarlyStopping(patience=2)]).history
    assert len(th["loss"]) == len(jh["loss"]) == 4
