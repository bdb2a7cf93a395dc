"""The port's native loader against the reference's.

The port builds its own copy of the loader (``csrc/loader.cpp``) with this
machine's ``g++`` into ``tpu_dist_torch/_build/`` and binds it with
``ctypes``; ``shuffled_indices``, ``gather_scale`` and ``gather_labels``
must equal the reference's ``tpu_dist.data.native`` bit for bit, and so
must the port's numpy path (a machine without a toolchain).
``native_pipeline`` must stream the reference's batches, host-scaled or
uint8 with the scale as a device transform.
"""

import numpy as np
import pytest

from tpu_dist.data import native as jnative
from tpu_dist_torch.data import native


def _images(n=300, shape=(28, 28, 1), seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, *shape),
                                                dtype=np.uint8)


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's loader as on a machine without ``g++``."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_the_library_builds_into_the_ports_build_dir():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    # The port's own source and build directory, never the reference's.
    for p in (path.parent, native.SOURCE.parent):
        assert p.parent.name == "tpu_dist_torch"


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 3), (1000, 0),
                                    (60000, 12345), (777, 2**63 + 5)])
def test_shuffled_indices_match_reference(n, seed):
    calls = native.calls["shuffled_indices"]
    got = native.shuffled_indices(n, seed)
    np.testing.assert_array_equal(got, jnative.shuffled_indices(n, seed))
    assert native.calls["shuffled_indices"] == calls + 1


def test_numpy_path_matches_reference(numpy_path):
    np.testing.assert_array_equal(native.shuffled_indices(500, 9),
                                  jnative.shuffled_indices(500, 9))
    x, idx = _images(64), np.arange(63, -1, -3)
    np.testing.assert_array_equal(native.gather_scale(x, idx, 1 / 255),
                                  jnative.gather_scale(x, idx, 1 / 255))
    y = np.arange(64, dtype=np.int64) * 7
    np.testing.assert_array_equal(native.gather_labels(y, idx),
                                  jnative.gather_labels(y, idx))


@pytest.mark.parametrize("scale,threads", [(1 / 255, None), (1 / 255, 1),
                                           (0.5, 3), (2.0, 8)])
def test_gather_scale_matches_reference(scale, threads):
    x = _images()
    idx = native.shuffled_indices(len(x), 4)[:200]
    calls = native.calls["gather_scale"]
    got = native.gather_scale(x, idx, scale, n_threads=threads)
    want = jnative.gather_scale(x, idx, scale, n_threads=threads)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, x[idx].astype(np.float32) * np.float32(scale))
    assert native.calls["gather_scale"] == calls + 1


def test_gather_labels_matches_reference():
    y = np.random.default_rng(1).integers(0, 10, 300).astype(np.int64)
    idx = native.shuffled_indices(300, 8)
    np.testing.assert_array_equal(native.gather_labels(y, idx),
                                  jnative.gather_labels(y, idx))
    # Rows of more than one element take the numpy path in both.
    y2 = y.reshape(150, 2)
    np.testing.assert_array_equal(native.gather_labels(y2, idx[:20] // 2),
                                  jnative.gather_labels(y2, idx[:20] // 2))


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_native_pipeline_streams_the_references(transfer):
    kw = dict(global_batch_size=64, seed=3, synthetic_size=256,
              transfer=transfer)
    ours = native.native_pipeline("mnist", **kw)
    ref = jnative.native_pipeline("mnist", **kw)
    assert ours.cardinality() == ref.cardinality() == 4
    for _ in range(2):   # each pass reshuffles
        for (gx, gy), (wx, wy) in zip(ours, ref):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    t = ours._device_transform
    if transfer == "uint8":
        assert (t._op, t._scale) == ("mul", 1 / 255)
        gx, _ = next(iter(ours))
        np.testing.assert_array_equal(
            t(gx).numpy(), gx.astype(np.float32) * np.float32(1 / 255))
    else:
        assert t is None


def test_native_pipeline_auto_transfer_follows_the_device():
    kw = dict(global_batch_size=32, synthetic_size=64)
    assert native.native_pipeline("mnist", device="cpu",
                                  **kw)._device_transform is None
    assert native.native_pipeline("mnist", **kw)._device_transform
    with pytest.raises(ValueError, match="transfer"):
        native.native_pipeline("mnist", transfer="int4", **kw)
