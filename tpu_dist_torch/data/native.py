"""The native (C++) input-pipeline core, with a numpy path beside it.

Counterpart of ``tpu_dist/data/native.py``. The host's hot path — a
shuffled, normalized batch gathered from an in-memory dataset — runs as
one multithreaded C++ pass (``csrc/loader.cpp``, the port's own copy of
the JAX package's loader): rows gathered by shuffled index and converted
uint8 -> float32 * scale in one sweep, the work of the reference's
``.map(scale) ... .shuffle(...).batch(...)``.

The library is built with ``g++`` at its first use in a process, into
``tpu_dist_torch/_build/`` (gitignored), named by a hash of the source and
the flags; the build writes a per-process temporary file that
``os.replace`` moves into place, so processes that race the first build
never load half a library. Without a toolchain every function takes its
numpy path, with a warning: this is host code, not a kernel, and its
results are bit-identical either way (the shuffle is the same seeded
SplitMix64 Fisher-Yates in both). :data:`calls` counts the calls the
library served.

    ds = native_pipeline("mnist", global_batch_size=128, seed=0)
    model.fit(ds, epochs=10, steps_per_epoch=20)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("tpu_dist_torch.native")

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

#: Calls served by the native library, by function (the numpy path does
#: not count).
calls = {"shuffled_indices": 0, "gather_scale": 0, "gather_labels": 0}


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"loader-{digest}.so"


def _build(path: pathlib.Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        logger.info("built native loader: %s", path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native loader build failed (%s %s); using the numpy "
                       "path", e, detail.decode(errors="replace")[:500])
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    """The loader library, built at first use; None: the numpy path."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("loading native loader %s failed (%s); using the "
                           "numpy path", path, e)
            _build_failed = True
            return None
        lib.tpu_dist_gather_scale_u8_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
        lib.tpu_dist_gather_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.tpu_dist_shuffled_indices.argtypes = [
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p]
        for fn in (lib.tpu_dist_gather_scale_u8_f32, lib.tpu_dist_gather_i64,
                   lib.tpu_dist_shuffled_indices):
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# -- the primitives (native, or numpy with the same results) --------------------


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Seeded Fisher-Yates permutation of [0, n), the same stream native
    or not."""
    out = np.empty(n, dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.tpu_dist_shuffled_indices(
            n, ctypes.c_uint64(seed & (2**64 - 1)),
            out.ctypes.data_as(ctypes.c_void_p))
        calls["shuffled_indices"] += 1
        return out
    out[:] = np.arange(n, dtype=np.int64)
    mask = (1 << 64) - 1
    state = seed & mask
    for i in range(n - 1, 0, -1):
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        z = z ^ (z >> 31)
        j = z % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


#: Bytes of output per loader thread when ``n_threads`` is not given: a
#: thread costs more to start than a small batch takes to gather (a
#: batch of 64 MNIST images runs fastest on one).
BYTES_PER_THREAD = 1 << 20


def gather_scale(images: np.ndarray, idx: np.ndarray, scale: float,
                 n_threads: int | None = None) -> np.ndarray:
    """out[i] = float32(images[idx[i]]) * scale, gathered and scaled in
    one pass. Without ``n_threads``, one thread per
    :data:`BYTES_PER_THREAD` of output, at most 8 (the JAX package starts
    8 for any batch of 32 rows or more); the bits are the same for any
    thread count."""
    images = np.ascontiguousarray(images)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    row_elems = int(np.prod(images.shape[1:], dtype=np.int64))
    out = np.empty((len(idx), *images.shape[1:]), dtype=np.float32)
    lib = _load()
    if lib is not None and images.dtype == np.uint8:
        if n_threads is None:
            n_threads = max(1, min(8, os.cpu_count() or 1,
                                   out.nbytes // BYTES_PER_THREAD))
        lib.tpu_dist_gather_scale_u8_f32(
            images.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p),
            len(idx), row_elems, ctypes.c_float(scale),
            out.ctypes.data_as(ctypes.c_void_p), n_threads)
        calls["gather_scale"] += 1
        return out
    # A float32 product, the native path's arithmetic.
    np.multiply(images[idx].astype(np.float32), np.float32(scale), out=out)
    return out


def gather_labels(labels: np.ndarray, idx: np.ndarray) -> np.ndarray:
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    lib = _load()
    if lib is not None and labels.ndim == 1:
        out = np.empty(len(idx), dtype=np.int64)
        lib.tpu_dist_gather_i64(
            labels.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p),
            len(idx), 1, out.ctypes.data_as(ctypes.c_void_p))
        calls["gather_labels"] += 1
        return out
    return labels[idx]


# -- the pipeline front end -------------------------------------------------------


def native_pipeline(name: str, *, global_batch_size: int, seed: int = 0,
                    split: str = "train", scale: float = 1.0 / 255.0,
                    drop_remainder: bool = True,
                    synthetic_size: int | None = None,
                    transfer: str = "auto", device=None):
    """A ``Dataset`` over a named source whose batches the native core
    assembles: a seeded reshuffle per pass, gather and normalize fused.

    Equals ``load(name, split).map(scale).cache().shuffle(N).batch(B)``
    with a buffer as large as the dataset, and goes into ``fit`` or
    ``experimental_distribute_dataset`` like any other Dataset.

    ``transfer``: ``"float32"`` normalizes on the host (the fused C++
    pass); ``"uint8"`` yields the raw bytes with the scale attached as a
    device transform, which the trainer applies on its device — a quarter
    of the bytes cross to the card. ``"auto"`` takes uint8 for a uint8
    source bound for a device other than the CPU (``device``, CUDA by
    default, as the port's entry points are).
    """
    import torch

    from tpu_dist_torch.data.pipeline import Dataset
    from tpu_dist_torch.data.sources import load_arrays

    images, labels = load_arrays(name, split, synthetic_size=synthetic_size)
    n = len(images)
    if global_batch_size > n:
        raise ValueError(f"batch {global_batch_size} exceeds dataset size {n}")
    if transfer == "auto":
        target = torch.device("cuda" if device is None else device)
        transfer = ("uint8" if target.type != "cpu"
                    and images.dtype == np.uint8 else "float32")
    if transfer not in ("uint8", "float32"):
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if transfer == "uint8" and images.dtype != np.uint8:
        raise ValueError(
            f"transfer='uint8' requires a uint8 source, got {images.dtype}")
    epoch_counter = [0]
    steps = (n // global_batch_size if drop_remainder
             else -(-n // global_batch_size))
    device_scale = transfer == "uint8"
    images = np.ascontiguousarray(images)

    def factory():
        # A fresh permutation each pass: the factory runs once per epoch.
        perm = shuffled_indices(n, seed + 0x9E37 * epoch_counter[0])
        epoch_counter[0] += 1
        for s in range(steps):
            idx = perm[s * global_batch_size:(s + 1) * global_batch_size]
            if device_scale:
                yield images[idx], gather_labels(labels, idx)
            else:
                yield (gather_scale(images, idx, scale),
                       gather_labels(labels, idx))

    ds = Dataset(factory, cardinality=steps)
    if device_scale:
        from tpu_dist_torch.data.vectorize import device_scale_fn

        ds._device_transform = device_scale_fn(scale)
    return ds
