"""The port's vectorized chain rewrite and device promotion against the
reference's (``tests/test_vectorize.py`` mirrored).

Bar: the rewrite changes how a stream is computed, never what it is. Each
rewritten port stream must equal, bit for bit, the reference's element
path on the same source, seed and chain (and so the reference's own
rewrite); every chain the reference declines, the port declines too; a
normalization map is detected with the same formula (``mul`` or ``div``,
which differ in the last ulp) and, deferred to the device, gives the
element path's float32 bits. The promotion's decisions follow the
reference's, with the port's two questions (is the target device the CPU,
does ``torch.distributed`` run several processes) patched where the
reference's tests patch the JAX backend.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_dist import data as jdata
from tpu_dist.data import vectorize as jvectorize
from tpu_dist.data.pipeline import Dataset as JDataset
from tpu_dist_torch import data as tdata
from tpu_dist_torch.data import native, vectorize
from tpu_dist_torch.data.device import DeviceDataset
from tpu_dist_torch.data.pipeline import Dataset


def _mnist_arrays(n=512):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(n, 28, 28, 1), dtype=np.uint8)
    y = rng.integers(0, 10, size=(n,)).astype(np.int64)
    return x, y


def _scale(image, label):
    return np.asarray(image, np.float32) / 255.0, label


def _assert_stream_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == len(w)
        for ga, wa in zip(g, w):
            ga, wa = np.asarray(ga), np.asarray(wa)
            assert ga.dtype == wa.dtype, (ga.dtype, wa.dtype)
            np.testing.assert_array_equal(ga, wa)


def _vectorized(ds) -> bool:
    """True when ``ds`` or a dataset under its prefetch is the rewrite's."""
    while ds is not None and not getattr(ds, "_vectorized", False):
        ds = ds._parent
    return ds is not None


def _both(build):
    """The chain in the port and in the reference."""
    return build(Dataset), build(JDataset)


CHAINS = {
    "reference_chain_seeded": (512, lambda D, x, y: (
        D.from_tensor_slices((x, y)).map(_scale).cache()
        .shuffle(100, seed=7).batch(64))),
    "full_buffer_shuffle": (256, lambda D, x, y: (
        D.from_tensor_slices((x, y)).map(_scale)
        .shuffle(10000, seed=3).batch(32))),
    "take_then_repeat": (128, lambda D, x, y: (
        D.from_tensor_slices((x, y)).batch(16).take(3).repeat(2))),
    "repeat_then_take": (128, lambda D, x, y: (
        D.from_tensor_slices((x, y)).batch(16).repeat(2).take(3))),
    "skip_then_repeat": (128, lambda D, x, y: (
        D.from_tensor_slices((x, y)).batch(16).skip(2).repeat(1))),
    "skip_take_shard_before_batch": (128, lambda D, x, y: (
        D.from_tensor_slices((x, y)).skip(8).take(100).shard(2, 1)
        .batch(8))),
    "drop_remainder": (100, lambda D, x, y: (
        D.from_tensor_slices((x, y)).batch(32, drop_remainder=True))),
    "short_final_batch": (100, lambda D, x, y: (
        D.from_tensor_slices((x, y)).batch(32))),
    "post_batch_shard_and_prefetch": (128, lambda D, x, y: (
        D.from_tensor_slices((x, y)).map(_scale).batch(8).shard(3, 2)
        .prefetch(2))),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_rewrite_equals_the_reference_element_path(chain):
    n, build = CHAINS[chain]
    x, y = _mnist_arrays(n)
    ours, ref = _both(lambda D: build(D, x, y))
    fast = vectorize.try_rewrite(ours, defer_scale_to_device=False)
    assert fast is not None and _vectorized(fast)
    assert fast.cardinality() == ref.cardinality()
    _assert_stream_equal(fast, ref)
    jfast = jvectorize.try_rewrite(build(JDataset, x, y),
                                   defer_scale_to_device=False)
    _assert_stream_equal(vectorize.try_rewrite(
        build(Dataset, x, y), defer_scale_to_device=False), jfast)


def test_generic_vectorizable_map_without_cache():
    x = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    y = np.arange(64, dtype=np.int64)

    def affine(a, b):
        return a * 2.0 - 1.0, b

    ours, ref = _both(lambda D: D.from_tensor_slices((x, y)).map(affine)
                      .batch(16))
    fast = vectorize.try_rewrite(ours)
    assert fast is not None
    _assert_stream_equal(fast, ref)


def test_second_epoch_reshuffles_like_element_path():
    x, y = _mnist_arrays(256)
    ours, ref = _both(lambda D: D.from_tensor_slices((x, y))
                      .shuffle(64, seed=11).batch(32))
    fast = vectorize.try_rewrite(ours)
    f1, f2 = list(fast), list(fast)
    _assert_stream_equal(f1, ref)
    _assert_stream_equal(f2, ref)
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(f1, f2))


def test_unseeded_shuffle_same_multiset():
    x, y = _mnist_arrays(128)
    ds = (Dataset.from_tensor_slices((x, y)).map(_scale)
          .shuffle(10000).batch(32))
    fast = vectorize.try_rewrite(ds, defer_scale_to_device=False)
    assert fast is not None
    got = np.concatenate([b[1] for b in fast])
    assert sorted(got.tolist()) == sorted(y.tolist())


DECLINES = {
    "random_map": lambda D, rng: D.from_tensor_slices(_mnist_arrays(64)).map(
        lambda a, b: (a.astype(np.float32) + rng.normal(), b)).batch(16),
    "non_batch_safe_map": lambda D, rng: D.from_tensor_slices(
        (np.arange(256, dtype=np.float32).reshape(64, 4),
         np.arange(64, dtype=np.int64))).map(
        lambda a, b: (a.reshape(-1), b)).batch(16),
    "filter": lambda D, rng: D.from_tensor_slices(_mnist_arrays(64)).filter(
        lambda a, b: b < 5).batch(8),
    "generator_source": lambda D, rng: D.from_generator(
        lambda: iter([1, 2, 3])).batch(2),
    "cache_after_shuffle": lambda D, rng: D.from_tensor_slices(
        _mnist_arrays(64)).shuffle(16, seed=1).cache().batch(8),
    "no_batch": lambda D, rng: D.from_tensor_slices(_mnist_arrays(64)),
    "two_shuffles": lambda D, rng: D.from_tensor_slices(_mnist_arrays(64))
    .shuffle(8, seed=1).shuffle(8, seed=2).batch(8),
}


@pytest.mark.parametrize("chain", sorted(DECLINES))
def test_declines_what_the_reference_declines(chain):
    ours, ref = _both(lambda D: DECLINES[chain](D, np.random.default_rng(5)))
    assert jvectorize.try_rewrite(ref, defer_scale_to_device=False) is None
    assert vectorize.try_rewrite(ours, defer_scale_to_device=False) is None


def test_env_kill_switch(monkeypatch):
    x, y = _mnist_arrays(64)
    ds = Dataset.from_tensor_slices((x, y)).batch(8)
    assert vectorize.try_rewrite(ds) is not None
    monkeypatch.setenv("TPU_DIST_VECTORIZE", "0")
    assert vectorize.try_rewrite(ds) is None
    assert vectorize.try_promote_to_device(ds, "cuda") is None


def test_scale_detected_and_fused_on_host():
    x, y = _mnist_arrays(128)

    def scale_mul(image, label):
        return np.asarray(image, np.float32) * np.float32(1 / 255), label

    ours, ref = _both(lambda D: D.from_tensor_slices((x, y)).map(scale_mul)
                      .cache().shuffle(10000, seed=2).batch(32))
    calls = native.calls["gather_scale"]
    fast = vectorize.try_rewrite(ours, defer_scale_to_device=False)
    assert fast is not None and fast._device_transform is None
    _assert_stream_equal(fast, ref)
    if native.native_available():
        assert native.calls["gather_scale"] == calls + 4


@pytest.mark.parametrize("op", ["div", "mul"])
def test_scale_deferred_to_the_device_keeps_the_formula(op):
    x, y = _mnist_arrays(128)

    def scale(image, label):
        image = np.asarray(image, np.float32)
        return (image / 255.0 if op == "div"
                else image * np.float32(2.0)), label

    ours, ref = _both(lambda D: D.from_tensor_slices((x, y)).map(scale)
                      .shuffle(10000, seed=2).batch(32))
    fast = vectorize.try_rewrite(ours, defer_scale_to_device=True)
    jfast = jvectorize.try_rewrite(
        JDataset.from_tensor_slices((x, y)).map(scale)
        .shuffle(10000, seed=2).batch(32), defer_scale_to_device=True)
    t, jt = fast._device_transform, jfast._device_transform
    assert (t._op, t._scale) == (jt._op, jt._scale)
    assert (t._op, t._scale) == (("div", 255.0) if op == "div"
                                 else ("mul", 2.0))
    fb = list(fast)
    assert len(fb) == 4
    for (gx, gy), (wx, wy) in zip(fb, ref):
        assert gx.dtype == np.uint8
        got = t(gx)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), wx)
        np.testing.assert_array_equal(gy, wy)
    # The device is the consumer's: a CPU consumer keeps host scaling.
    assert vectorize.try_rewrite(ours, device="cpu")._device_transform is None
    assert vectorize.try_rewrite(ours, device="cuda")._device_transform


ADVERSARIAL = {
    "batch_conditional": (
        lambda: (np.where(np.arange(256)[:, None, None, None] >= 128, 250,
                          10).astype(np.uint8) * np.ones((1, 4, 4, 1),
                                                          np.uint8),
                 (np.arange(256) % 10).astype(np.int64)),
        lambda image, label: ((np.asarray(image, np.float32) * 2.0
                               if np.asarray(image, np.float32).max() > 200.0
                               else np.asarray(image, np.float32)), label)),
    "label_conditional": (
        lambda: (np.zeros((128, 4, 4, 1), np.uint8),
                 (np.arange(128) % 10).astype(np.int64)),
        lambda image, label: ((np.asarray(image, np.float32) + 1.0
                               if np.ndim(label) == 0 and int(label) == 7
                               else np.asarray(image, np.float32)), label)),
}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_maps_decline(case):
    make, fn = ADVERSARIAL[case]
    ours, ref = _both(lambda D: D.from_tensor_slices(make()).map(fn).batch(32))
    assert jvectorize.try_rewrite(ref, defer_scale_to_device=False) is None
    assert vectorize.try_rewrite(ours, defer_scale_to_device=False) is None


def test_elementwise_fn_still_accepted():
    x, y = _mnist_arrays(128)

    def affine(image, label):
        return np.asarray(image, np.float32) * 0.5 - 1.0, label

    ours, ref = _both(lambda D: D.from_tensor_slices((x, y)).map(affine)
                      .batch(32))
    fast = vectorize.try_rewrite(ours, defer_scale_to_device=False)
    assert fast is not None
    _assert_stream_equal(fast, ref)


# -- the promotion ------------------------------------------------------------


def _chain(D, n=256, batch=32, shuffle=True, seed=None):
    x, y = _mnist_arrays(n)
    ds = D.from_tensor_slices((x, y)).map(_scale).cache()
    if shuffle:
        ds = ds.shuffle(10000, seed=seed)
    return ds.batch(batch), (x, y)


def test_promotion_declines_on_the_cpu_and_in_a_process_group(monkeypatch):
    ds, _ = _chain(Dataset)
    assert vectorize.try_promote_to_device(ds, "cpu") is None
    assert jvectorize.try_promote_to_device(_chain(JDataset)[0]) is None
    monkeypatch.setattr(vectorize, "_multi_process", lambda: True)
    assert vectorize.try_promote_to_device(ds, "cuda") is None


def test_promotes_and_matches_data():
    ds, (x, y) = _chain(Dataset)
    out = vectorize.try_promote_to_device(ds, "cuda")
    assert isinstance(out, DeviceDataset)
    assert (out._scale_op, out._scale) == ("div", 255.0)
    assert out.device.type == "cuda" and out.uploads == 0  # lazy upload
    out.bind_device("cpu")
    got_x, got_y = [], []
    for _ in range(out.cardinality()):
        xb, yb = out.next_batch()
        got_x.append(xb.numpy())
        got_y.append(yb.numpy())
    assert out.uploads == 1
    assert sorted(np.concatenate(got_y).tolist()) == sorted(y.tolist())
    gx = np.concatenate(got_x)
    assert gx.dtype == np.float32
    # Each sample scaled exactly as the host map does: x / 255 in float32.
    np.testing.assert_array_equal(gx, _scale(x[out._perm], None)[0])
    # One dataset (one upload) per chain, however many calls.
    assert vectorize.try_promote_to_device(ds, "cuda") is out


def test_promotion_decisions_follow_the_reference(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x, y = _mnist_arrays(100)
    for build in (lambda D: _chain(D, seed=9)[0],
                  lambda D: _chain(D)[0].repeat(),
                  lambda D: D.from_tensor_slices((x, y)).batch(32),
                  lambda D: D.from_tensor_slices((x, y)).batch(
                      32, drop_remainder=True),
                  lambda D: _chain(D, shuffle=False)[0],
                  lambda D: _chain(D)[0].with_options(
                      (tdata if D is Dataset else jdata).Options())
                  .prefetch(2),
                  lambda D: _chain(D)[0].take(3),
                  lambda D: D.from_tensor_slices((x, y)).map(
                      lambda a, b: (np.asarray(a, np.float32) + 1.0, b))
                  .batch(20)):
        want = jvectorize.try_promote_to_device(build(JDataset)) is not None
        got = vectorize.try_promote_to_device(build(Dataset), "cuda")
        assert (got is not None) == want


def test_the_reference_programs_scale_is_detected_on_synthetic_mnist():
    # The JAX package reads the divisor off the first nonzero byte of its
    # probe (156 in the synthetic MNIST: 156 / fl(156 / 255) = 254.99998)
    # and so declines the reference program's own x / 255; the port reads
    # it off the largest byte and promotes the chain. Either way the
    # stream is the element path's, bit for bit.
    x, y = tdata.load_arrays("mnist", "train", synthetic_size=1024)
    assert jvectorize._detect_scale([_scale], (x, y)) is None
    assert vectorize._detect_scale([_scale], (x, y)) == ("div", 255.0)
    ours, ref = _both(lambda D: D.from_tensor_slices((x, y)).map(_scale)
                      .cache().shuffle(10000, seed=4).batch(64))
    fast = vectorize.try_rewrite(ours, device="cuda")
    t = fast._device_transform
    for (gx, gy), (wx, wy) in zip(fast, ref):
        np.testing.assert_array_equal(t(gx).numpy(), wx)
        np.testing.assert_array_equal(gy, wy)
    promoted = vectorize.try_promote_to_device(_chain(Dataset)[0], "cuda")
    assert promoted is not None and promoted._scale_op == "div"
