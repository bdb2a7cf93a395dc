"""Device-resident datasets: upload once, gather every batch on the device.

Counterpart of ``tpu_dist/data/device.py``. A dataset that fits on the
card (MNIST is 47 MB as uint8, CIFAR-10 157 MB, against 80 GB) crosses to
the device once; each step's batch is then an ``index_select`` there,
driven by an index vector of a few hundred bytes that the host draws and
sends through pinned memory. No pixel crosses the link after the upload.

Semantics: ``load(name, "train").map(scale).cache().shuffle(FULL)
.batch(B, drop_remainder=True)`` with a seeded reshuffle per pass, drawn
exactly as the JAX package draws it (``default_rng(seed + epoch)
.permutation``), so both packages gather the same batches. Nothing is
sharded: one process trains on one card, as in the port's strategy.

    ds = device_pipeline("mnist", global_batch_size=128)
    model.fit(ds, epochs=10, steps_per_epoch=20)
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, Optional

import numpy as np
import torch

from tpu_dist_torch.data.vectorize import device_scale_fn
from tpu_dist_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("tpu_dist_torch.data")


class DeviceDataset:
    """A device-resident ``(images, labels)`` dataset batched on the device.

    ``fit`` and ``evaluate`` take it as it is: ``next_batch`` for a step,
    ``next_stack(k)`` for a k-step execution, ``next_indices`` and
    :meth:`gather` for an execution that gathers inside its own captured
    program, and iteration for an evaluation pass. The images stay in
    their source dtype on the device (uint8: a quarter of float32's
    memory); the scale runs after the gather, with the chain's own formula
    (``scale_op``: ``x * scale`` or ``x / scale``, which differ in the
    last ulp).

    ``device`` is where the arrays go (default: the trainer's device when
    ``fit`` binds it, else CUDA by the port's rule). ``uploads`` counts
    the uploads, ``upload_seconds`` times the last one,
    ``index_bytes`` counts the bytes of the index vectors drawn for the
    device, the only bytes a batch sends, and ``index_copies`` the
    host-to-device copies of index vectors this object issued.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 global_batch_size: int, seed: int = 0, shuffle: bool = True,
                 scale: Optional[float] = 1.0 / 255.0,
                 scale_op: str = "mul", device: DeviceLike = None):
        if scale_op not in ("mul", "div"):
            raise ValueError(f"scale_op must be 'mul' or 'div', "
                             f"got {scale_op!r}")
        n = len(images)
        if len(labels) != n:
            raise ValueError(f"images/labels disagree: {n} vs {len(labels)}")
        if global_batch_size > n:
            raise ValueError(
                f"batch {global_batch_size} exceeds dataset size {n}")
        self._host_x = np.ascontiguousarray(images)
        self._host_y = np.ascontiguousarray(labels.astype(np.int64))
        self._n = n
        self._batch = int(global_batch_size)
        self._seed = seed
        self._shuffle = shuffle
        self._scale = None if scale is None else float(scale)
        self._scale_op = scale_op
        self._transform = (None if scale is None
                           else device_scale_fn(self._scale, scale_op))
        self._device = None if device is None else torch.device(device)
        self._dx: Optional[torch.Tensor] = None
        self._dy: Optional[torch.Tensor] = None
        self._epoch = 0
        self._eval_pass = 0  # evaluation draws from its own seed stream
        self._perm: Optional[np.ndarray] = None
        self._pos = 0
        #: One pinned staging buffer per index-vector size, written again
        #: only once the copy that read it last has finished (the event).
        self._staging: dict[int, torch.Tensor] = {}
        self._copied: Optional[torch.cuda.Event] = None
        self.uploads = 0
        self.upload_seconds: Optional[float] = None
        self.index_bytes = 0
        self.index_copies = 0

    def bind_device(self, device: DeviceLike) -> "DeviceDataset":
        """Pin (or move) the dataset to ``device``: ``fit`` binds it to the
        trainer's device, so a dataset built for no device lands where the
        model trains; another device uploads again from the host arrays."""
        device = torch.device(device)
        if device == self._device:
            return self
        if self._dx is not None:
            logger.info("DeviceDataset: moving from %s to %s", self._device,
                        device)
        self._device = device
        self._dx = self._dy = None
        self._staging.clear()
        return self

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def _ensure_placed(self) -> None:
        """Upload once: pinned host copies, one non-blocking copy each, one
        synchronize. On the CPU the device arrays are the host arrays."""
        if self._dx is not None:
            return
        if self._device is None:
            self._device = resolve_device(None)
        t0 = time.perf_counter()
        x, y = torch.from_numpy(self._host_x), torch.from_numpy(self._host_y)
        if self._device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
            self._dx = x.to(self._device, non_blocking=True)
            self._dy = y.to(self._device, non_blocking=True)
            torch.cuda.synchronize(self._device)
        else:
            self._dx, self._dy = x.to(self._device), y.to(self._device)
        self.upload_seconds = time.perf_counter() - t0
        self.uploads += 1

    # -- introspection (the Dataset surface) -----------------------------------

    def cardinality(self) -> int:
        """Batches per epoch (the remainder is dropped: a batch's shape is
        fixed)."""
        return self._n // self._batch

    @property
    def global_batch_size(self) -> int:
        return self._batch

    @property
    def element_spec(self):
        return (self._host_x.shape[1:], self._host_y.shape[1:])

    @property
    def upload_bytes(self) -> int:
        return self._host_x.nbytes + self._host_y.nbytes

    # -- the gather -----------------------------------------------------------

    def gather(self, idx: torch.Tensor):
        """``(images, labels)`` for a device index tensor of any shape: one
        ``index_select`` each, then the scale; the result has ``idx``'s
        shape in front. Host work and device ops only, so a CUDA graph can
        capture it."""
        self._ensure_placed()
        flat = idx.reshape(-1)
        xb = self._dx.index_select(0, flat).view(*idx.shape,
                                                 *self._dx.shape[1:])
        yb = self._dy.index_select(0, flat).view(*idx.shape,
                                                 *self._dy.shape[1:])
        if self._transform is not None:
            xb = self._transform(xb)
        return xb, yb

    def _send(self, idx: np.ndarray) -> torch.Tensor:
        """The index vector on the device: through a pinned staging buffer
        and a non-blocking copy on the current stream on CUDA."""
        self.index_bytes += idx.nbytes
        if self._device.type != "cuda":
            return torch.from_numpy(idx)
        host = self._staging.get(idx.size)
        if host is None:
            host = self._staging[idx.size] = torch.empty(
                idx.size, dtype=torch.int32, pin_memory=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.synchronize()  # the last copy out of the staging is done
        host.numpy()[:] = idx.reshape(-1)
        out = host.to(self._device, non_blocking=True)
        self.index_copies += 1
        self._copied.record()
        return out.view(idx.shape)

    # -- iteration ------------------------------------------------------------

    def _next_indices(self, count: int) -> np.ndarray:
        """``count`` sample indices, continuing the epoch's permutation (a
        fresh seeded permutation each pass)."""
        out = np.empty(count, dtype=np.int32)
        per_epoch = self.cardinality() * self._batch
        filled = 0
        while filled < count:
            if self._perm is None or self._pos >= per_epoch:
                if self._shuffle:
                    rng = np.random.default_rng(self._seed + self._epoch)
                    self._perm = rng.permutation(self._n).astype(np.int32)
                else:
                    self._perm = np.arange(self._n, dtype=np.int32)
                self._epoch += 1
                self._pos = 0
            take = min(count - filled, per_epoch - self._pos)
            out[filled:filled + take] = self._perm[self._pos:self._pos + take]
            filled += take
            self._pos += take
        return out

    def tell(self) -> tuple:
        """Where the training order stands, for :meth:`seek`."""
        return self._epoch, self._pos, self._perm

    def seek(self, position: Optional[tuple]) -> None:
        """Go back to a :meth:`tell` position (the trainer's rollback to an
        epoch's start); None: the start of a fresh dataset's order."""
        self._epoch, self._pos, self._perm = position or (0, 0, None)

    def next_indices(self, k: int) -> np.ndarray:
        """The next ``k`` batches' sample indices, ``[k, B]`` int32, for a
        caller that sends them and gathers itself (:meth:`gather`)."""
        self._ensure_placed()
        idx = self._next_indices(k * self._batch).reshape(k, self._batch)
        self.index_bytes += idx.nbytes
        return idx

    def next_batch(self):
        """One batch on the device: ``(images [B, ...], labels [B])``."""
        self._ensure_placed()
        return self.gather(self._send(self._next_indices(self._batch)))

    def next_stack(self, k: int):
        """``k`` batches stacked, ``[k, B, ...]``, for a k-step
        execution."""
        self._ensure_placed()
        idx = self._next_indices(k * self._batch).reshape(k, self._batch)
        return self.gather(self._send(idx))

    def __iter__(self) -> Iterator:
        """One full pass (an evaluation). A shuffled dataset draws a fresh
        permutation per pass from a seed stream of its own,
        ``default_rng((seed, 1, pass))``, so an evaluation between epochs
        leaves the training order where it was; unshuffled, the source
        order."""
        self._ensure_placed()
        if self._shuffle:
            rng = np.random.default_rng((self._seed, 1, self._eval_pass))
            self._eval_pass += 1
            order = rng.permutation(self._n).astype(np.int32)
        else:
            order = np.arange(self._n, dtype=np.int32)
        for s in range(self.cardinality()):
            yield self.gather(self._send(
                order[s * self._batch:(s + 1) * self._batch]))


def device_pipeline(name: str, *, global_batch_size: int, seed: int = 0,
                    split: str = "train", scale: float = 1.0 / 255.0,
                    shuffle: bool = True, device: DeviceLike = None,
                    synthetic_size: int | None = None) -> DeviceDataset:
    """A :class:`DeviceDataset` over a named source (local files, else the
    deterministic synthetic data; ``sources.py``)."""
    from tpu_dist_torch.data.sources import load_arrays

    images, labels = load_arrays(name, split, synthetic_size=synthetic_size)
    return DeviceDataset(images, labels, global_batch_size=global_batch_size,
                         seed=seed, shuffle=shuffle, scale=scale,
                         device=device)
