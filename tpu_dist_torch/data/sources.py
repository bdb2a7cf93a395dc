"""Dataset sources: MNIST / Fashion-MNIST / CIFAR-10 with a tfds-like loader.

Counterpart of ``tpu_dist/data/sources.py``. ``load(name, split,
as_supervised=True)`` returns a :class:`~tpu_dist_torch.data.pipeline.
Dataset` of ``(image, label)`` tuples. Resolution order per dataset, as in
the reference:

1. sharded npz files (``{name}-{split}.shard-00002-of-00008.npz``, written
   by :func:`write_sharded` — by either package, the layout is the same)
   as a file-backed Dataset that AutoShardPolicy.FILE strides across
   workers;
2. local files — idx/npz archives under ``$TPU_DIST_DATA_DIR``,
   ``~/.keras/datasets`` or ``~/tensorflow_datasets`` (nothing is ever
   downloaded);
3. deterministic synthetic data with the real shapes and dtypes and
   class-separable structure (a fixed per-class template plus noise), the
   reference's ``_synthetic`` bit for bit, so both packages train on the
   same images.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import gzip
import logging
import os
import pathlib
import struct
import zlib
from typing import Iterable, Mapping

import numpy as np

from tpu_dist_torch.data.pipeline import Dataset

logger = logging.getLogger("tpu_dist_torch.data")

DATA_DIR_ENV = "TPU_DIST_DATA_DIR"

#: name -> (image shape, num classes, official split sizes)
_SPECS: Mapping[str, tuple[tuple[int, int, int], int, Mapping[str, int]]] = {
    "mnist": ((28, 28, 1), 10, {"train": 60000, "test": 10000}),
    "fashion_mnist": ((28, 28, 1), 10, {"train": 60000, "test": 10000}),
    "cifar10": ((32, 32, 3), 10, {"train": 50000, "test": 10000}),
}

#: Synthetic split sizes; override with load(..., synthetic_size=N).
_SYNTHETIC_SIZES = {"train": 8192, "test": 1024}


def _search_dirs() -> list[pathlib.Path]:
    dirs = []
    env = os.environ.get(DATA_DIR_ENV)
    if env:
        dirs.append(pathlib.Path(env))
    home = pathlib.Path.home()
    dirs += [home / ".keras" / "datasets", home / "tensorflow_datasets"]
    return dirs


def _read_idx(path: pathlib.Path) -> np.ndarray:
    """Parse an IDX (MNIST-format) file, gzip or raw."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


_IDX_NAMES = {
    ("mnist", "train"): ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    ("mnist", "test"): ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ("fashion_mnist", "train"): ("train-images-idx3-ubyte",
                                 "train-labels-idx1-ubyte"),
    ("fashion_mnist", "test"): ("t10k-images-idx3-ubyte",
                                "t10k-labels-idx1-ubyte"),
}


def _try_local(name: str, split: str) -> tuple[np.ndarray, np.ndarray] | None:
    shape, _, _ = _SPECS[name]
    for base in _search_dirs():
        # npz bundle (keras-style mnist.npz / cifar10.npz)
        for fname in (f"{name}.npz", f"{name}-{split}.npz"):
            p = base / fname
            if p.is_file():
                with np.load(p, allow_pickle=False) as z:
                    kx, ky = (("x_train", "y_train") if split == "train"
                              else ("x_test", "y_test"))
                    if kx in z:
                        x, y = z[kx], z[ky]
                    elif "images" in z:
                        x, y = z["images"], z["labels"]
                    else:
                        continue
                logger.info("loaded %s/%s from %s", name, split, p)
                return x.reshape((-1, *shape)), y.reshape(-1).astype(np.int64)
        # idx files (raw MNIST distribution), possibly under a subdir
        key = (name, split)
        if key in _IDX_NAMES:
            for sub in (base, base / name):
                ix, iy = _IDX_NAMES[key]
                for suffix in ("", ".gz"):
                    px, py = sub / (ix + suffix), sub / (iy + suffix)
                    if px.is_file() and py.is_file():
                        x = _read_idx(px).reshape((-1, *shape))
                        y = _read_idx(py).reshape(-1).astype(np.int64)
                        logger.info("loaded %s/%s from %s", name, split, sub)
                        return x, y
    return None


def _synthetic(name: str, split: str,
               size: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Class-separable synthetic images: per-class low-frequency template +
    noise, deterministic per (name, split) so that every process sees the
    same dataset."""
    shape, num_classes, _ = _SPECS[name]
    n = size or _SYNTHETIC_SIZES[split]
    # Stable across processes and runs (Python's hash() is salted).
    seed = zlib.crc32(f"{name}/{split}".encode()) % (2**31)
    rng = np.random.default_rng(seed)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = np.stack([
        127.5 * (1 + np.sin(2 * np.pi * ((k + 1) * xx / w + k * yy / h)
                            / (1 + k % 3)))
        for k in range(num_classes)
    ])  # (classes, h, w)
    labels = rng.integers(num_classes, size=n).astype(np.int64)
    images = templates[labels][..., None].repeat(c, axis=-1)
    images = images + rng.normal(0, 24.0, size=(n, h, w, c))
    images = np.clip(images, 0, 255).astype(np.uint8)
    logger.warning(
        "no local copy of %s/%s found; using deterministic synthetic data "
        "(%d samples). Set $%s to use real data.", name, split, n,
        DATA_DIR_ENV)
    return images, labels


def _resolve_arrays(name: str, split: str, synthetic_size: int | None
                    ) -> tuple[np.ndarray, np.ndarray, bool]:
    """(images, labels, found_locally): local files, else synthetic."""
    if name not in _SPECS:
        raise ValueError(
            f"unknown dataset {name!r}; available: {sorted(_SPECS)}")
    valid = tuple(_SPECS[name][2])
    if split not in valid:
        raise ValueError(f"split must be one of {valid}, got {split!r}")
    found = _try_local(name, split)
    if found is not None:
        return (*found, True)
    return (*_synthetic(name, split, synthetic_size), False)


def load_arrays(name: str, split: str = "train", *,
                synthetic_size: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N, H, W, C], labels int64 [N]) for a named dataset."""
    x, y, _ = _resolve_arrays(name, split, synthetic_size)
    return x, y


def _find_shard_files(name: str, split: str) -> list[pathlib.Path]:
    """Sharded npz archives of ``name``/``split`` in the search dirs.

    Files are grouped by their ``-of-NNNNN`` generation and only a complete
    generation (all NNNNN files present) is served: re-sharding with
    another count leaves the old generation on disk, and mixing the two
    would duplicate every sample. Of several complete generations the most
    recently written wins."""
    pattern = f"{name}-{split}.shard-*-of-*.npz"
    for base in _search_dirs():
        for sub in (base, base / name):
            found = sorted(sub.glob(pattern)) if sub.is_dir() else []
            if not found:
                continue
            groups: dict[int, list[pathlib.Path]] = {}
            for p in found:
                try:
                    n = int(p.stem.rsplit("-of-", 1)[1])
                except (IndexError, ValueError):
                    continue
                groups.setdefault(n, []).append(p)
            complete = {n: fs for n, fs in groups.items() if len(fs) == n}
            if not complete:
                logger.warning(
                    "shard files under %s form no complete generation "
                    "(found %s); ignoring them",
                    sub, {n: len(fs) for n, fs in groups.items()})
                continue
            if len(complete) > 1:
                newest = max(
                    complete,
                    key=lambda n: max(p.stat().st_mtime for p in complete[n]))
                logger.warning(
                    "multiple complete shard generations for %s/%s under %s "
                    "(%s); using the newest (-of-%05d)", name, split, sub,
                    sorted(complete), newest)
                return complete[newest]
            return next(iter(complete.values()))
    return []


def _read_shard(path) -> Iterable[tuple[np.ndarray, np.int64]]:
    with np.load(path, allow_pickle=False) as z:
        images, labels = z["images"], z["labels"]
    for i in range(len(labels)):
        yield images[i], np.int64(labels[i])


def write_sharded(directory, name: str, split: str, images: np.ndarray,
                  labels: np.ndarray, num_shards: int) -> list[pathlib.Path]:
    """Split (images, labels) into ``num_shards`` npz files (shard ``s``
    holds rows ``s::num_shards``) that ``load`` finds and serves as a
    file-backed Dataset: the preparation step of an AutoShardPolicy.FILE
    job, where each worker then reads a disjoint subset of the files."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if not 1 <= num_shards <= len(labels):
        raise ValueError(
            f"num_shards must be in [1, {len(labels)}], got {num_shards}")
    paths = []
    for s in range(num_shards):
        p = directory / f"{name}-{split}.shard-{s:05d}-of-{num_shards:05d}.npz"
        np.savez(p, images=images[s::num_shards], labels=labels[s::num_shards])
        paths.append(p)
    logger.info("wrote %d shard files for %s/%s under %s",
                num_shards, name, split, directory)
    return paths


def _one_split(name: str, split: str, as_supervised: bool,
               synthetic_size: int | None) -> tuple[Dataset, bool]:
    """(dataset, served_synthetic) for one split: shard files first (per-
    file counts read from the npz headers, so a FILE-sharded worker still
    knows its cardinality), then single-file local copies, then synthetic
    data."""
    shards = _find_shard_files(name, split)
    if shards:
        counts = []
        for p in shards:
            with np.load(p, allow_pickle=False) as z:
                counts.append(len(z["labels"]))
        logger.info("loaded %s/%s from %d shard file(s) (%d samples)",
                    name, split, len(shards), sum(counts))
        if as_supervised:
            return Dataset.from_files(shards, _read_shard,
                                      file_cardinalities=counts), False
        return Dataset.from_files(
            shards,
            lambda p: ({"image": x, "label": y} for x, y in _read_shard(p)),
            file_cardinalities=counts), False
    x, y, found = _resolve_arrays(name, split, synthetic_size)
    ds = Dataset.from_tensor_slices(
        (x, y) if as_supervised else {"image": x, "label": y})
    return ds, not found


@dataclasses.dataclass(frozen=True)
class SplitInfo:
    """One entry of :attr:`DatasetInfo.splits`."""
    name: str
    num_examples: int


class _SplitBuilder:
    """Lazy build-and-cache of per-split Datasets, shared by the splits
    mapping and :class:`DatasetInfo`."""

    def __init__(self, name: str, splits: tuple[str, ...],
                 as_supervised: bool, synthetic_size: int | None):
        self.name, self.splits = name, splits
        self._as_supervised, self._size = as_supervised, synthetic_size
        self._cache: dict[str, tuple[Dataset, bool]] = {}
        self._served: set[str] = set()

    def get(self, split: str, *, serve: bool = True) -> tuple[Dataset, bool]:
        if split not in self._cache:
            self._cache[split] = _one_split(
                self.name, split, self._as_supervised, self._size)
        if serve:
            self._served.add(split)
        return self._cache[split]

    def any_synthetic(self) -> bool:
        return any(self._cache[s][1] for s in self._served)


class _LazySplits(collections.abc.Mapping):
    """The ``datasets`` mapping ``load(name)`` returns."""

    def __init__(self, builder: _SplitBuilder):
        self._builder = builder

    def __getitem__(self, split: str) -> Dataset:
        if split not in self._builder.splits:
            raise KeyError(split)
        return self._builder.get(split)[0]

    def __iter__(self):
        return iter(self._builder.splits)

    def __len__(self):
        return len(self._builder.splits)


class _LazySplitInfos(collections.abc.Mapping):
    """``info.splits``: SplitInfo from the split's cardinality."""

    def __init__(self, builder: _SplitBuilder):
        self._builder = builder

    def __getitem__(self, split: str) -> SplitInfo:
        if split not in self._builder.splits:
            raise KeyError(split)
        ds, _ = self._builder.get(split, serve=False)
        return SplitInfo(split, ds.cardinality())

    def __iter__(self):
        return iter(self._builder.splits)

    def __len__(self):
        return len(self._builder.splits)


class DatasetInfo:
    """Minimal ``tfds.core.DatasetInfo``: split cardinalities, image shape
    and class count; ``synthetic`` says whether a split served so far fell
    back to synthetic data."""

    def __init__(self, name: str, builder: _SplitBuilder):
        self.name = name
        self._builder = builder
        self.image_shape, self.num_classes, _ = _SPECS[name]
        self.splits: Mapping[str, SplitInfo] = _LazySplitInfos(builder)

    @property
    def synthetic(self) -> bool:
        return self._builder.any_synthetic()

    def __repr__(self):
        return (f"DatasetInfo(name={self.name!r}, "
                f"image_shape={self.image_shape}, "
                f"num_classes={self.num_classes}, "
                f"splits={list(self._builder.splits)})")


def disable_progress_bar() -> None:
    """``tfds.disable_progress_bar()`` analog: this loader never downloads,
    so there is no bar; provided so the reference program ports line for
    line."""


def load(name: str, split: str | None = None, *, as_supervised: bool = True,
         with_info: bool = False, synthetic_size: int | None = None):
    """``tfds.load``-shaped entry point: ``load('mnist', split='train')`` is
    one Dataset of ``(image, label)`` tuples (dicts without
    ``as_supervised``); without a split, ``{'train': ..., 'test': ...}``;
    ``with_info=True`` adds a :class:`DatasetInfo`. Over sharded files a
    split is file-backed (``num_files > 1``) and open to FILE sharding."""
    if name not in _SPECS:
        raise ValueError(
            f"unknown dataset {name!r}; available: {sorted(_SPECS)}")
    all_splits = tuple(_SPECS[name][2])
    if split is not None and split not in all_splits:
        raise ValueError(f"split must be one of {all_splits}, got {split!r}")
    builder = _SplitBuilder(name, all_splits, as_supervised, synthetic_size)
    result = _LazySplits(builder) if split is None else builder.get(split)[0]
    if not with_info:
        return result
    return result, DatasetInfo(name, builder)


def num_classes(name: str) -> int:
    return _SPECS[name][1]


def image_shape(name: str) -> tuple[int, int, int]:
    return _SPECS[name][0]
