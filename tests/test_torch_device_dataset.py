"""The port's DeviceDataset against the reference's, on ``device="cpu"``
(``tests/test_device_dataset.py`` mirrored).

Both packages draw a training pass's order from ``default_rng(seed +
epoch).permutation`` and an evaluation pass's from ``default_rng((seed, 1,
pass))``, so at the same seed ``next_batch``, ``next_stack`` and
evaluation passes gather the same samples: the port's batches must equal
the reference's bit for bit, scaled by ``mul`` or ``div`` or not at all.
``fit`` and ``evaluate`` on a DeviceDataset of the synthetic MNIST, on
the CNN with bridged weights, the fused CE and fused SGD (the CPU runs
their plain versions), must give the reference's per-epoch losses and
evaluation within ``test_torch_cnn.py``'s tolerance (atol = rtol = 1e-5),
and ``steps_per_execution=20`` must give k = 1's losses and parameters
exactly.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_dist as jtd
from tpu_dist.data.device import DeviceDataset as JDeviceDataset
from tpu_dist.data.device import device_pipeline as jdevice_pipeline
from tpu_dist.models import cnn as jcnn
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import metrics as jmetrics
from tpu_dist.ops import optimizers as jopt
from tpu_dist_torch.data import DeviceDataset, device_pipeline
from tpu_dist_torch.models import cnn
from tpu_dist_torch.ops import losses, metrics
from tpu_dist_torch.ops import optimizers as opt

TOL = dict(atol=1e-5, rtol=1e-5)


def _toy(n=256):
    x = (np.arange(n * 4) % 251).astype(np.uint8).reshape(n, 2, 2, 1)
    y = (np.arange(n) % 10).astype(np.int64)
    return x, y


@pytest.fixture(scope="module")
def jstrategy():
    return jtd.MirroredStrategy()


def _pair(jstrategy, x, y, **kw):
    return (DeviceDataset(x, y, device="cpu", **kw),
            JDeviceDataset(x, y, strategy=jstrategy, **kw))


def _same(got, want):
    """Equal bits; the labels are int64 in the port (they index) and int32
    in the reference (JAX without x64)."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert g.dtype == w.dtype or g.dtype.kind == w.dtype.kind == "i"
        np.testing.assert_array_equal(g, w)


class TestConstruction:
    def test_refusals(self):
        x, y = _toy(16)
        with pytest.raises(ValueError, match="exceeds"):
            DeviceDataset(x, y, global_batch_size=32)
        with pytest.raises(ValueError, match="disagree"):
            DeviceDataset(x, y[:-1], global_batch_size=8)
        with pytest.raises(ValueError, match="scale_op"):
            DeviceDataset(x, y, global_batch_size=8, scale_op="pow")

    def test_cardinality_drops_the_remainder(self):
        x, y = _toy(100)
        assert DeviceDataset(x, y, global_batch_size=32).cardinality() == 3

    def test_uploads_once_and_stays_uint8(self):
        x, y = _toy()
        ds = DeviceDataset(x, y, global_batch_size=32, device="cpu")
        assert ds.uploads == 0
        xb, yb = ds.next_batch()
        ds.next_stack(3)
        list(ds)
        assert ds.uploads == 1 and ds._dx.dtype == torch.uint8
        assert xb.shape == (32, 2, 2, 1) and xb.dtype == torch.float32
        assert yb.dtype == torch.int64
        assert ds.element_spec == ((2, 2, 1), ())
        assert ds.upload_bytes == x.nbytes + 8 * len(y)
        # Batches, stacks and evaluation passes all count their indices.
        assert ds.index_bytes == 4 * 32 * (1 + 3 + ds.cardinality())


@pytest.mark.parametrize("scale,op", [(1.0 / 255.0, "mul"), (None, "mul")])
def test_batches_equal_the_references(jstrategy, scale, op):
    x, y = _toy()
    ours, ref = _pair(jstrategy, x, y, global_batch_size=32, seed=7,
                      scale=scale, scale_op=op)
    for _ in range(2 * ours.cardinality() + 3):   # across epochs
        _same(ours.next_batch(), ref.next_batch())
    _same(ours.next_stack(4), ref.next_stack(4))
    for _ in range(2):   # evaluation passes draw their own permutations
        for got, want in zip(ours, ref):
            _same(got, want)
    _same(ours.next_batch(), ref.next_batch())


def test_division_keeps_the_host_chains_bits(jstrategy):
    """``scale_op="div"`` replays a chain's ``x / 255``: the port divides
    in IEEE float32, as numpy does on the host, so its batches are the
    host chain's bit for bit. The reference's jitted division on the CPU
    multiplies by the reciprocal (XLA rewrites a division by a constant),
    which is off by one ulp for some bytes: it is held to the same samples
    within that ulp."""
    x, y = _toy()
    ours, ref = _pair(jstrategy, x, y, global_batch_size=32, seed=7,
                      scale=255.0, scale_op="div")
    for _ in range(ours.cardinality() + 2):
        (gx, gy), (wx, wy) = ours.next_batch(), ref.next_batch()
        idx = ours._perm[ours._pos - 32:ours._pos]
        np.testing.assert_array_equal(
            gx.numpy(), x[idx].astype(np.float32) / np.float32(255))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
        np.testing.assert_array_max_ulp(gx.numpy(), np.asarray(wx), maxulp=1)


def test_unshuffled_passes_keep_the_source_order(jstrategy):
    x, y = _toy(64)
    ours, ref = _pair(jstrategy, x, y, global_batch_size=16, shuffle=False)
    got = [int(v) for _, yb in ours for v in yb]
    assert got == [int(v) for v in y]
    _same(ours.next_stack(2), ref.next_stack(2))


def test_epoch_covers_every_sample_once_and_reshuffles():
    x, y = _toy(64)
    ds = DeviceDataset(x, y, global_batch_size=16, seed=7, device="cpu")
    first = np.concatenate([ds.next_batch()[1].numpy() for _ in range(4)])
    second = np.concatenate([ds.next_batch()[1].numpy() for _ in range(4)])
    assert sorted(first) == sorted(second) == sorted(y)
    assert not np.array_equal(first, second)


def test_eval_pass_does_not_shift_training_order():
    x, y = _toy(64)
    mk = lambda: DeviceDataset(x, y, global_batch_size=8, seed=3,
                               device="cpu")
    ref, probed = mk(), mk()
    want = [ref.next_batch()[0] for _ in range(16)]
    got = [probed.next_batch()[0] for _ in range(5)]
    list(probed)
    got += [probed.next_batch()[0] for _ in range(11)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _compile(model, k: int = 1):
    model.compile(
        optimizer=opt.SGD(learning_rate=0.01, fused=True),
        loss=losses.SparseCategoricalCrossentropy(from_logits=True,
                                                  fused=True),
        metrics=[metrics.SparseCategoricalAccuracy()], device="cpu",
        steps_per_execution=k)
    return model


def test_fit_and_evaluate_match_the_reference():
    jmodel = jcnn.build_cnn_model()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(0)["params"])
    model = cnn.build_cnn_model()
    model.load_jax_params(params)
    jmodel.compile(
        optimizer=jopt.SGD(learning_rate=0.01, fused=True),
        loss=jlosses.SparseCategoricalCrossentropy(from_logits=True,
                                                   fused=True),
        metrics=[jmetrics.SparseCategoricalAccuracy()])
    _compile(model)
    kw = dict(global_batch_size=64, seed=0, synthetic_size=256)
    train = device_pipeline("mnist", device="cpu", **kw)
    val = device_pipeline("mnist", split="test", device="cpu", **kw)
    jh = jmodel.fit(jdevice_pipeline("mnist", **kw), epochs=2,
                    validation_data=jdevice_pipeline("mnist", split="test",
                                                     **kw),
                    verbose=0).history
    th = model.fit(train, epochs=2, validation_data=val, verbose=0).history
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(th[key], [float(v) for v in jh[key]],
                                   err_msg=key, **TOL)
    assert th["loss"][1] < th["loss"][0]
    assert train.uploads == 1 and train.cardinality() == 4
    # ``val`` served two validation passes; its third is held to the
    # third pass of a dataset of the reference's.
    got = model.evaluate(val, verbose=0)
    ref_val = jdevice_pipeline("mnist", split="test", **kw)
    list(ref_val), list(ref_val)
    want = jmodel.evaluate(ref_val, verbose=0)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key], float(want[key]), err_msg=key,
                                   **TOL)


def test_steps_per_execution_equals_one_step_at_a_time():
    runs = []
    for k in (1, 20):
        model = _compile(cnn.build_cnn_model(seed=3), k)
        ds = device_pipeline("mnist", global_batch_size=8, seed=1,
                             synthetic_size=160, device="cpu")
        h = model.fit(ds, epochs=2, steps_per_epoch=20, verbose=0).history
        runs.append((h["loss"], [p.detach().clone()
                                 for p in model.parameters()]))
    (l1, p1), (l20, p20) = runs
    assert l20 == l1
    for a, b in zip(p20, p1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
