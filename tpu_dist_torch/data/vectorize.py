"""Vectorized execution of combinator chains over in-memory sources.

Counterpart of ``tpu_dist/data/vectorize.py``: the rewrite pass over the
chain each ``Dataset`` records (``_parent`` / ``_transform``, with the
source arrays in ``_tensor_source``), the role TF's Grappler passes
(map-and-batch fusion, map vectorization) play for tf.data. For a chain of
the shape the reference builds

    from_tensor_slices -> map(fn)* -> cache? -> shuffle -> batch [-> repeat
        / take / skip / shard / prefetch / with_options]

the element walk (a Python frame per example, an ``np.stack`` of B small
arrays per batch) becomes index math and batched gathers:

* the shuffle runs over an ``int64`` index array with ``Dataset.shuffle``'s
  buffer algorithm and rng construction, so a seeded chain gives the
  element path's batches bit for bit;
* each batch is one fancy-index gather instead of B yields and a stack;
* a ``map`` is vectorized only if it passes a probe: applied to a sample
  batch it must equal the stack of its per-element results exactly, and
  applied twice it must agree with itself; anything else keeps the
  element path;
* a map that probes as a pure uint8 normalization (``astype(float32) * k``
  or ``/ d``) fuses into the native loader's gather (``native.py``), or,
  for a consumer on a device other than the CPU, is deferred to that
  device (``Dataset._device_transform``): the batch crosses to the card as
  uint8, a quarter of the bytes, and the trainer scales it in its step.

:func:`try_promote_to_device` goes further for a chain that fits on the
card: the arrays are uploaded once and every batch is gathered there
(``data/device.py``). Where the JAX package asks whether its backend is
the CPU, the port asks whether the target device is; where it asks for
more than one JAX process, the port asks whether ``torch.distributed``
runs a group of more than one. Both functions return None for any chain
outside the grammar, so correctness never depends on them;
``TPU_DIST_VECTORIZE=0`` turns both off.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Any, Callable

import numpy as np

from tpu_dist_torch.data.pipeline import Dataset, _call, _map_structure

logger = logging.getLogger("tpu_dist_torch.data")

#: Pre-batch ops the index planner understands.
_PRE_BATCH = {"map", "cache", "shuffle", "skip", "take", "shard"}
#: Post-batch ops replayed on the batch stream.
_POST_BATCH = {"repeat", "take", "skip", "shard", "prefetch", "with_options"}
#: The JAX package's limit on promoted images, which leaves the card room.
PROMOTE_MAX_BYTES = 512 * 1024 * 1024


def enabled() -> bool:
    return os.environ.get("TPU_DIST_VECTORIZE", "").strip() != "0"


def _multi_process() -> bool:
    """True when ``torch.distributed`` runs a group of several processes."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


# -- chain parsing ------------------------------------------------------------


def _collect_chain(ds: Dataset):
    """(source Dataset, [transform (name, kwargs) source->sink]) or None."""
    steps: list[tuple[str, dict]] = []
    node = ds
    while node is not None:
        if getattr(node, "_tensor_source", None) is not None:
            return node, list(reversed(steps))
        t = node._transform
        if t is None:
            return None
        steps.append(t)
        node = node._parent
    return None


def _parse(ds: Dataset):
    """Split a supported chain into (source, pre-batch ops, batch kwargs,
    post-batch ops); None outside the grammar."""
    got = _collect_chain(ds)
    if got is None:
        return None
    source, steps = got
    pre: list[tuple[str, dict]] = []
    post: list[tuple[str, dict]] = []
    batch_kw = None
    for name, kw in steps:
        if batch_kw is None:
            if name == "batch":
                batch_kw = kw
            elif name in _PRE_BATCH:
                pre.append((name, kw))
            else:
                return None
        elif name in _POST_BATCH:
            post.append((name, kw))
        else:
            return None
    if batch_kw is None:
        return None
    # One shuffle, never before a cache (a cache after a shuffle freezes
    # the first pass's order, which the index planner does not reproduce).
    shuffle_seen = False
    for name, _ in pre:
        if name == "shuffle":
            if shuffle_seen:
                return None
            shuffle_seen = True
        if name == "cache" and shuffle_seen:
            return None
    return source, pre, batch_kw, post


# -- map probing --------------------------------------------------------------


def _leaves(el) -> list[np.ndarray]:
    out: list[np.ndarray] = []
    _map_structure(lambda a: out.append(np.asarray(a)), el)
    return out


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        for x, y in zip(la, lb))


def _element(arrays, i: int):
    return _map_structure(lambda a: a[i], arrays)


def _probe_indices(arrays) -> np.ndarray:
    """The probe's sample: an evenly spaced sweep of the source plus the
    first occurrence of every value of each small-integer leaf, so a
    value- or class-conditional function shows itself."""
    leaves = _leaves(arrays)
    n = len(leaves[0])
    idx = np.linspace(0, n - 1, num=min(n, 32), dtype=np.int64)
    for leaf in leaves:
        if leaf.dtype.kind in "iu" and leaf.ndim <= 2:
            _, first = np.unique(leaf.reshape(n, -1)[:, 0], return_index=True)
            idx = np.concatenate([idx, first[:16].astype(np.int64)])
    return np.unique(idx)


def _probe_vectorizable(fn: Callable, arrays) -> bool:
    """``fn`` of the sample batch must equal the stack of ``fn`` of each
    sample element exactly, and ``fn`` of one element twice must agree.
    Elementwise math passes bit for bit; a reduction, a reshape or a
    batch-level condition does not, and keeps the element path."""
    try:
        idx = _probe_indices(arrays)
        e0 = _element(arrays, int(idx[0]))
        f0a, f0b = _call(fn, e0), _call(fn, e0)
        if not _same(f0a, f0b):
            return False  # not deterministic (a random augmentation)
        per_el = [f0a] + [_call(fn, _element(arrays, int(i)))
                          for i in idx[1:]]
        got = _leaves(_call(fn, _map_structure(
            lambda a: np.asarray(a)[idx], arrays)))
        want = [np.stack(cols) for cols in zip(*(_leaves(r) for r in per_el))]
        return len(got) == len(want) and all(
            g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
            for g, w in zip(got, want))
    except Exception:
        return False


def _detect_scale(fns: list[Callable], arrays) -> tuple[str, float] | None:
    """``("mul", k)`` or ``("div", d)`` when the composed maps over a
    ``(uint8 image, label)`` source are exactly ``image.astype(float32) *
    k`` or ``/ d`` with the label untouched; None otherwise. ``x / 255``
    and ``x * (1 / 255)`` differ in the last ulp for many inputs, so the
    exact formula is detected and replayed."""
    if not (isinstance(arrays, tuple) and len(arrays) == 2):
        return None
    images, labels = np.asarray(arrays[0]), np.asarray(arrays[1])
    if images.dtype != np.uint8 or len(images) < 2:
        return None
    try:
        # The scale replaces fn for the whole dataset, so the probe is
        # adversarial: an even sweep, one image of every label value, and
        # a crafted image cycling all 256 byte values.
        n = len(images)
        idx = list(np.linspace(0, n - 1, num=min(n, 64), dtype=np.int64))
        _, first_of_label = np.unique(
            labels.reshape(len(labels), -1)[:, 0], return_index=True)
        idx = np.unique(np.concatenate(
            [idx, first_of_label[:32]]).astype(np.int64))
        ramp = (np.arange(int(np.prod(images.shape[1:])) or 1,
                          dtype=np.int64) % 256).astype(np.uint8)
        probe_x = np.concatenate(
            [images[idx], ramp.reshape(1, *images.shape[1:])])
        probe_y = np.concatenate([labels[idx], labels[idx[:1]]])
        out = (probe_x, probe_y)
        for fn in fns:
            out = _call(fn, out)
        if not (isinstance(out, tuple) and len(out) == 2):
            return None
        oimg, olab = np.asarray(out[0]), np.asarray(out[1])
        if oimg.dtype != np.float32 or oimg.shape != probe_x.shape:
            return None
        if not np.array_equal(olab, probe_y):
            return None
        src = probe_x.astype(np.float32)
        # The factor is read off the largest byte (the ramp holds 255),
        # where the output's rounding moves it least, and tried with its
        # float32 neighbours: the JAX package reads the first nonzero byte,
        # and for the synthetic MNIST's (156) gets 156 / fl(156 / 255) =
        # 254.99998, which declines the reference program's own x / 255.
        # Whatever factor is taken must give the map's bits on the whole
        # probe.
        top = int(np.argmax(src))
        s, o = float(src.flat[top]), float(oimg.flat[top])
        if s == 0.0 or o == 0.0:
            return None
        detected = None
        for op, estimate in (("mul", np.float32(o / s)),
                             ("div", np.float32(s / o))):
            for f in (estimate, np.nextafter(estimate, np.float32(0)),
                      np.nextafter(estimate, np.float32(np.inf))):
                if np.array_equal(oimg, src * f if op == "mul" else src / f):
                    detected = (op, float(f))
                    break
            if detected is not None:
                break
        if detected is None:
            return None
        # The pipeline applies fn per element; the formula was checked on
        # a batch. Check every probe element alone too: a fn that branches
        # on a scalar label would otherwise pass.
        for i in range(len(probe_x)):
            single = (probe_x[i], probe_y[i])
            for fn in fns:
                single = _call(fn, single)
            if not (np.array_equal(np.asarray(single[0]), oimg[i])
                    and np.array_equal(np.asarray(single[1]), olab[i])):
                return None
        return detected
    except Exception:
        return None


# -- the index pipeline -----------------------------------------------------------


def _buffer_shuffle_indices(idx: np.ndarray, buffer_size: int,
                            rng) -> np.ndarray:
    """``Dataset.shuffle``'s buffer algorithm over an index array, with the
    same rng calls in the same order."""
    n = len(idx)
    if buffer_size >= n:
        out = list(idx)
        rng.shuffle(out)  # the element path: the whole buffer, one shuffle
        return np.asarray(out, dtype=idx.dtype)
    out = np.empty(n, dtype=idx.dtype)
    buf = list(idx[:buffer_size])
    k = 0
    for el in idx[buffer_size:]:
        j = int(rng.integers(len(buf)))
        out[k] = buf[j]
        buf[j] = el
        k += 1
    rng.shuffle(buf)
    out[k:] = buf
    return out


class _IndexPlan:
    """The index stream of each pass through the pre-batch ops."""

    def __init__(self, n: int, pre: list[tuple[str, dict]]):
        self.n = n
        self.ops = [(name, kw) for name, kw in pre
                    if name not in ("map", "cache")]

    def epoch(self, epoch_no: int) -> np.ndarray:
        idx = np.arange(self.n, dtype=np.int64)
        for name, kw in self.ops:
            if name == "shuffle":
                seed = kw["seed"]
                if seed is None:
                    rng = np.random.default_rng()
                else:
                    rng = np.random.default_rng(
                        seed + (epoch_no if kw["reshuffle_each_iteration"]
                                else 0))
                idx = _buffer_shuffle_indices(idx, kw["buffer_size"], rng)
            elif name == "skip":
                idx = idx[kw["count"]:]
            elif name == "take":
                idx = idx[:kw["count"]]
            elif name == "shard":
                idx = idx[kw["index"]::kw["num_shards"]]
        return idx


# -- the rewrite --------------------------------------------------------------


def device_scale_fn(k: float, op: str = "mul"):
    """The host normalization replayed on the batch's device with the same
    formula: ``float32(x) * k`` or ``float32(x) / k`` in IEEE float32.
    ``k`` is a 0-d tensor on the batch's device, made there by a fill
    (nothing crosses from the host, so a CUDA graph can capture it): a
    CUDA division by a host scalar multiplies by its reciprocal instead,
    which can differ from numpy's quotient in the last ulp."""
    if op not in ("mul", "div"):
        raise ValueError(f"scale op must be 'mul' or 'div', got {op!r}")

    def transform(x):
        import torch

        x = torch.as_tensor(x).to(torch.float32)
        s = torch.full((), k, dtype=torch.float32, device=x.device)
        return x * s if op == "mul" else x / s

    transform._scale = k  # read by the trainer's program keys and tests
    transform._op = op
    return transform


def try_promote_to_device(ds: Dataset, device):
    """A :class:`~tpu_dist_torch.data.device.DeviceDataset` for a
    reference-shaped chain over a source that fits on the card: the arrays
    cross to ``device`` once, and every batch is gathered there from an
    index vector the host sends (a few hundred bytes a step). None unless
    all of these hold:

    * one process (the multi-worker OFF mode's independent shuffles per
      worker are not one global permutation);
    * ``device`` is not the CPU (there the device memory is the host's);
    * the chain is source -> map* -> cache? -> shuffle? -> batch, with the
      maps detected as a pure normalization (:func:`_detect_scale`) or
      absent, and only ``prefetch`` / ``with_options`` after the batch;
    * any shuffle is unseeded and reshuffles each pass (a seeded order is
      honored by declining);
    * the batch divides the dataset or drops the remainder (a batch's
      shape is fixed), and the images take at most 512 MiB.

    The result is kept on ``ds``: every later call for it returns the same
    dataset, uploaded once.
    """
    import torch

    if not enabled():
        return None
    cached = getattr(ds, "_device_promoted", None)
    if cached is not None:
        return cached
    if torch.device(device).type == "cpu" or _multi_process():
        return None
    parsed = _parse(ds)
    if parsed is None:
        return None
    source, pre, batch_kw, post = parsed
    arrays = source._tensor_source
    if not (isinstance(arrays, tuple) and len(arrays) == 2):
        return None
    images, labels = np.asarray(arrays[0]), np.asarray(arrays[1])
    if images.nbytes > PROMOTE_MAX_BYTES:
        return None
    if not np.issubdtype(labels.dtype, np.integer):
        return None
    n = len(images)
    batch = batch_kw["batch_size"]
    if n % batch and not batch_kw["drop_remainder"]:
        return None
    if any(name in ("skip", "take", "shard") for name, _ in pre):
        return None
    if any(name not in ("prefetch", "with_options") for name, _ in post):
        return None
    shuffle = False
    for name, kw in pre:
        if name == "shuffle":
            if kw["seed"] is not None or not kw["reshuffle_each_iteration"]:
                return None
            shuffle = True
    fns = [kw["fn"] for name, kw in pre if name == "map"]
    scale, scale_op = None, "mul"
    if fns:
        detected = _detect_scale(fns, arrays)
        if detected is None:
            return None
        scale_op, scale = detected
    from tpu_dist_torch.data.device import DeviceDataset

    # The chain's shuffle is unseeded: a seed of its own is that contract.
    out = DeviceDataset(  # shardcheck: disable=SC601 -- chain declared an UNSEEDED shuffle; a random seed IS that contract
        images, labels, global_batch_size=batch,
        seed=int(np.random.default_rng().integers(2**31)),
        shuffle=shuffle, scale=scale, scale_op=scale_op, device=device)
    logger.info("vectorize: promoted a %d-element chain to %s (%.1f MB "
                "uploaded once, index vectors per step)", n, device,
                images.nbytes / 1e6)
    ds._device_promoted = out  # shardcheck: disable=SC900 -- promotion cache attribute, never persisted; taint ends here
    return out


def try_rewrite(ds: Dataset, *, defer_scale_to_device: bool | None = None,
                device=None) -> Dataset | None:
    """A Dataset that yields ``ds``'s batch stream through index math and
    batched gathers, or None when ``ds``'s chain is outside the grammar.

    ``defer_scale_to_device`` (None: true when ``device`` is given and is
    not the CPU) yields uint8 images with the normalization as a device
    transform; otherwise a multiplying scale fuses into the native loader's
    gather on the host."""
    if not enabled():
        return None
    parsed = _parse(ds)
    if parsed is None:
        return None
    source, pre, batch_kw, post = parsed
    arrays = source._tensor_source
    n = source.cardinality()
    if n is None or n < 2:
        return None

    fns = [kw["fn"] for name, kw in pre if name == "map"]
    cache_present = any(name == "cache" for name, _ in pre)
    scale = _detect_scale(fns, arrays) if fns else None

    if defer_scale_to_device is None:
        import torch

        defer_scale_to_device = (device is not None
                                 and torch.device(device).type != "cpu")
    if scale is not None and scale[0] != "mul" and not defer_scale_to_device:
        # The native gather multiplies; a division replayed on the host
        # stays exact only through the generic batched path.
        scale = None
    if scale is None:
        for fn in fns:
            if not _probe_vectorizable(fn, arrays):
                logger.debug("vectorize: map fn %r is not batch-safe; "
                             "keeping the element path", fn)
                return None

    plan = _IndexPlan(n, pre)
    batch_size = batch_kw["batch_size"]
    drop_remainder = batch_kw["drop_remainder"]

    device_transform = None
    if scale is not None:
        from tpu_dist_torch.data import native

        scale_op, scale_k = scale
        images = np.ascontiguousarray(np.asarray(arrays[0]))
        labels = np.asarray(arrays[1])
        if defer_scale_to_device:
            device_transform = device_scale_fn(scale_k, scale_op)

            def make_batch(idx):
                return images[idx], native.gather_labels(labels, idx)
        else:
            def make_batch(idx):
                return (native.gather_scale(images, idx, scale_k),
                        native.gather_labels(labels, idx))
    else:
        # Generic: gather (from arrays mapped once, under a cache), then
        # apply the probed maps to the batch. Without a cache the maps run
        # again on every pass, as on the element path.
        state: dict[str, Any] = {}

        def materialized():
            if "arrays" not in state:
                out = arrays
                for fn in fns:
                    out = _call(fn, _map_structure(np.asarray, out))
                state["arrays"] = _map_structure(np.asarray, out)
            return state["arrays"]

        if cache_present:
            def make_batch(idx):
                return _map_structure(lambda a: a[idx], materialized())
        else:
            def make_batch(idx):
                el = _map_structure(lambda a: np.asarray(a)[idx], arrays)
                for fn in fns:
                    el = _call(fn, el)
                return _map_structure(np.asarray, el)

    epoch_counter = [0]

    def one_pass():
        idx = plan.epoch(epoch_counter[0])
        epoch_counter[0] += 1
        m = len(idx)
        stop = m - (m % batch_size) if drop_remainder else m
        for s in range(0, stop, batch_size):
            yield make_batch(idx[s:s + batch_size])

    def repeated(inner: Callable, count):
        def gen():
            done = 0
            while count is None or done < count:
                empty = True
                for el in inner():
                    empty = False
                    yield el
                if empty:
                    return
                done += 1
        return gen

    # The post-batch ops fold over the batch stream in their recorded
    # order (take then repeat loops the prefix; repeat then take bounds
    # the loop).
    stream: Callable = one_pass
    for name, kw in post:
        if name == "repeat":
            stream = repeated(stream, kw["count"])
        elif name == "take":
            stream = (lambda f=stream, c=kw["count"]:
                      itertools.islice(f(), c))
        elif name == "skip":
            stream = (lambda f=stream, c=kw["count"]:
                      itertools.islice(f(), c, None))
        elif name == "shard":
            stream = (lambda f=stream, i=kw["index"], k=kw["num_shards"]:
                      itertools.islice(f(), i, None, k))

    out = Dataset(stream, options=ds._options,
                  cardinality=ds.cardinality(), num_files=ds.num_files)
    out._device_transform = device_transform
    out._vectorized = True
    mode = ("fused-scale->device-u8" if device_transform is not None else
            "fused-scale-native" if scale is not None else "batched-maps")
    logger.info("vectorize: rewrote a %d-op chain over %d elements (%s)",
                len(pre) + 1 + len(post), n, mode)
    # A prefetch of the original chain's tail runs on the rewritten stream.
    for name, kw in post:
        if name == "prefetch":
            out = out.prefetch(kw["buffer_size"])
            break
    return out
