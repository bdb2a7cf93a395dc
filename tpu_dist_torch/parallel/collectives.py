"""Collectives: communication modes, reduce ops and the cross-process
collectives over tensors, trees of tensors and host arrays.

Counterpart of ``tpu_dist/parallel/collectives.py``. There, XLA compiles
the step's gradient all-reduce into the program; here the trainer calls
:func:`all_reduce` on the step's gradients once per step, packed into one
flat buffer (the reference's single end-of-step all-reduce), or
:func:`bucketed_all_reduce` in size buckets under
``compile(gradient_bucket_bytes=)``, over the process group that
``cluster/bootstrap.py`` brought up. A collective runs over the whole
process group, or over the subgroup ``group=`` names: a mesh axis's
(``parallel/mesh.axis_group``; :data:`~tpu_dist_torch.parallel.mesh.SELF`
is this process alone). With one process every collective is the
identity.

Trees are nests of dicts, lists, tuples and NamedTuples, flattened as
``jax.tree_util`` flattens them: dicts in sorted key order, ``None`` holds
no leaf. So :func:`partition_buckets` gives the reference's index lists on
the same tree of the same shapes, and every process builds the same
sequence of collectives from the shapes alone (a rank-divergent order
would deadlock).

Three seams, the reference's: :func:`set_collective_logging` logs every
collective's shapes (TF's INFO lines); a fault hook
(:func:`install_fault_hook`) is called with the op's name before each
wrapper here and ``bootstrap.barrier`` does its work, so a chaos harness
can delay or fail it; an observe hook (:func:`install_observe_hook`) is
called after, with the payload's leaf count and bytes and, for the host
collectives and the barrier, the host seconds they took. A firing inside
a CUDA-graph capture is tagged ``phase="trace"`` (it records work that
replays, as a JAX trace does) and the fault hook does not fire there. A
hook failure of the observe hook is logged and swallowed. With no hook
installed each costs one pointer check.
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.cluster import bootstrap

logger = logging.getLogger("tpu_dist_torch.collectives")

#: Flip with :func:`set_collective_logging`.
_LOG_COLLECTIVES = False
_FAULT_HOOK = None
_OBSERVE_HOOK = None


def set_collective_logging(enabled: bool) -> None:
    global _LOG_COLLECTIVES
    _LOG_COLLECTIVES = bool(enabled)


def install_fault_hook(hook):
    """Install (or, with None, remove) the collective fault hook:
    ``hook(op_name)``, called before each host-level collective; it may
    sleep or raise. Returns the previous hook."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    return prev


def _capturing() -> bool:
    """Is this thread's current stream capturing a CUDA graph?"""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def fire_fault_hook(op: str) -> None:
    """Call the installed fault hook, but not inside a capture, where a
    sleep would stall the recording and not the step."""
    hook = _FAULT_HOOK
    if hook is None or _capturing():
        return
    hook(op)


def install_observe_hook(hook):
    """Install (or, with None, remove) the collective observe hook:
    ``hook(op, *, phase, leaves, nbytes, seconds)``, called after each
    wrapper; ``phase`` is ``"eager"`` or ``"trace"`` (inside a capture),
    ``seconds`` the host wall time of a host-level collective (None for
    the others). Returns the previous hook."""
    global _OBSERVE_HOOK
    prev = _OBSERVE_HOOK
    _OBSERVE_HOOK = hook
    return prev


def _tree_payload(tree: Any) -> tuple[int, int]:
    """(leaf count, payload bytes) of a tree; opaque leaves count 0."""
    leaves = tree_leaves(tree)
    return len(leaves), sum(_leaf_nbytes(leaf) for leaf in leaves)


def fire_observe_hook(op: str, tree: Any = None, *,
                      seconds: Optional[float] = None) -> None:
    """Report one collective call to the installed observe hook. A hook
    failure is logged and swallowed: telemetry never takes down the
    collective it watches."""
    hook = _OBSERVE_HOOK
    if hook is None:
        return
    phase = "trace" if _capturing() else "eager"
    leaves, nbytes = (0, 0) if tree is None else _tree_payload(tree)
    try:
        hook(op, phase=phase, leaves=leaves, nbytes=nbytes, seconds=seconds)
    except Exception:  # noqa: BLE001 - observability is best-effort
        logger.debug("observe hook failed for %s", op, exc_info=True)


def _log_tree(op: str, tree: Any) -> None:
    if not _LOG_COLLECTIVES:
        return
    leaves = tree_leaves(tree)
    logger.info(
        "Collective %s tensors: %d all_reduces, group_size = %s, shapes = %s",
        op, len(leaves), bootstrap.process_count(),
        [tuple(np.shape(leaf)) for leaf in leaves])


class CollectiveCommunication(enum.Enum):
    """Communication implementation — TF's ``AUTO``/``RING``/``NCCL``, and
    the process group's backend in the port (``bootstrap.backend_for``):
    RING is TF's collective implementation that does not use NCCL, here
    gloo, on CUDA tensors too (gloo stages them through the host); NCCL is
    NCCL, which needs CUDA; AUTO is NCCL on CUDA and gloo on the CPU."""

    AUTO = "AUTO"
    RING = "RING"
    NCCL = "NCCL"

    @classmethod
    def resolve(cls, value: "CollectiveCommunication | str | None"):
        if value is None:
            return cls.AUTO
        if isinstance(value, str):
            try:
                value = cls[value.upper()]
            except KeyError:
                raise ValueError(
                    f"unknown CollectiveCommunication {value!r}; valid: "
                    f"{[m.name for m in cls]}") from None
        return value


class ReduceOp(enum.Enum):
    """Cross-replica reduction op; MEAN is SUM / group size, as in TF."""

    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"


_DIST_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MEAN: "SUM", ReduceOp.MAX: "MAX",
             ReduceOp.MIN: "MIN"}

#: ``group=`` for this process alone (``parallel/mesh.SELF``).
_SELF = "self"


def group_size(group=None) -> int:
    """The number of processes in ``group`` (None: the whole process
    group; ``"self"``: 1)."""
    if group == _SELF or not bootstrap.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_root(group=None) -> int:
    """The global rank of the first process of ``group`` (a process
    group, or None: the whole one)."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def _reduce_op(op) -> ReduceOp:
    return ReduceOp(op) if not isinstance(op, ReduceOp) else op


def _reduce_flat(tensors: Sequence[torch.Tensor], op: ReduceOp,
                 world: int, group=None) -> None:
    """One collective over ``tensors`` (one dtype, one device), packed into
    a flat buffer, reduced and copied back in place."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                    group=group)
    if op is ReduceOp.MEAN:
        flat /= world
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce(tensors: Sequence[torch.Tensor],
               op: ReduceOp | str = ReduceOp.SUM, *,
               group=None) -> Sequence[torch.Tensor]:
    """Reduce every tensor across the processes of ``group`` (default:
    all), in place, in one collective: the tensors (one dtype, one device)
    are packed into a flat buffer, reduced, and copied back. Returns
    ``tensors``."""
    op = _reduce_op(op)
    fire_fault_hook("all_reduce")
    fire_observe_hook("all_reduce", list(tensors))
    _log_tree(f"all_reduce[{op.value}]", list(tensors))
    world = group_size(group)
    if world == 1 or not tensors:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce packs one dtype, got {sorted(map(str, dtypes))}")
    _reduce_flat(tensors, op, world, group)
    return tensors


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    out: list = []
    _leaves(tree, out)
    return out


def _leaves(tree, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            _leaves(sub, out)
    else:
        out.append(tree)


def _rebuild(tree, leaves):
    """``tree``'s structure over the next leaves of ``leaves``, taken in
    :func:`tree_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: built[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(sub, leaves) for sub in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return next(leaves)


def tree_map(fn, tree):
    """``fn`` of every leaf of ``tree``, in ``tree``'s structure."""
    return _rebuild(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def _leaf_nbytes(leaf: Any) -> int:
    """Payload bytes of one leaf (a tensor or an array); anything without
    a size and a dtype counts 0, as in the reference."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    size, dtype = getattr(leaf, "size", None), getattr(leaf, "dtype", None)
    if size is None or dtype is None:
        return 0
    try:
        return int(size) * np.dtype(dtype).itemsize
    except TypeError:
        return 0


def partition_buckets(tree: Any, bucket_bytes: int) -> list[list[int]]:
    """Size buckets of a tree's leaves for the reduction: a list of
    buckets, each a list of indices into :func:`tree_leaves`. Leaves are
    walked in reverse flatten order (the backward pass makes the last
    layer's gradients first); a bucket flushes once its bytes reach
    ``bucket_bytes``, so a leaf larger than the budget gets a bucket of
    its own. ``bucket_bytes <= 0`` gives one bucket of every leaf (still
    reversed). The partition depends on the leaves' shapes and dtypes
    alone, so every process computes the same one."""
    leaves = tree_leaves(tree)
    if not leaves:
        return []
    indices = list(range(len(leaves)))[::-1]
    if bucket_bytes <= 0:
        return [indices]
    buckets: list[list[int]] = []
    current: list[int] = []
    current_bytes = 0
    for i in indices:
        current.append(i)
        current_bytes += _leaf_nbytes(leaves[i])
        if current_bytes >= bucket_bytes:
            buckets.append(current)
            current, current_bytes = [], 0
    if current:
        buckets.append(current)
    return buckets


def bucketed_all_reduce(tree: Any, op: ReduceOp | str = ReduceOp.MEAN, *,
                        bucket_bytes: int = 0, group=None) -> Any:
    """Reduce a tree of tensors across the processes in size buckets, in
    place: the leaves of each :func:`partition_buckets` bucket are grouped
    by dtype (first-occurrence order, the same on every process) and each
    group is one packed ``dist.all_reduce`` (MEAN divides by the world
    size). Packing is a concatenation and a split, so the result equals a
    per-leaf :func:`all_reduce` of the same inputs bit for bit. MAX and
    MIN delegate to :func:`all_reduce` per dtype. With one process the
    tree comes back as it is. Returns ``tree``.

    ``bucketed_all_reduce.launches`` counts the packed collectives, one
    per (bucket, dtype) group. The buckets are reduced one after another
    once the backward pass has ended; launching each as its last gradient
    lands is ROADMAP's K8."""
    op = _reduce_op(op)
    world = group_size(group)
    leaves = tree_leaves(tree)
    if world == 1 or not leaves:
        return tree
    fire_fault_hook("bucketed_all_reduce")
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        for dtype in dict.fromkeys(t.dtype for t in leaves):
            all_reduce([t for t in leaves if t.dtype == dtype], op,
                       group=group)
        return tree
    for bucket in partition_buckets(tree, bucket_bytes):
        by_dtype: dict = {}
        for i in bucket:
            by_dtype.setdefault(leaves[i].dtype, []).append(leaves[i])
        for packed in by_dtype.values():
            fire_observe_hook("bucketed_all_reduce", packed)
            _log_tree(f"bucketed_all_reduce[{op.value}]", packed)
            bucketed_all_reduce.launches += 1
            _reduce_flat(packed, op, world, group)
    return tree


bucketed_all_reduce.launches = 0


def all_gather(x: Any, *, tiled: bool = False, axis: int = 0,
               group=None) -> Any:
    """Every process's value of each leaf of ``x`` (tensors, or numbers
    made tensors), identical on every process of ``group`` (default: all):
    stacked on a new leading axis ``[process_count, ...]``, or
    concatenated along ``axis`` (default the first) with ``tiled=True``.
    With one process, ``x[None]`` (``x`` tiled)."""
    fire_fault_hook("all_gather")
    fire_observe_hook("all_gather", x)
    _log_tree("all_gather", x)
    world = group_size(group)

    def gather(t):
        t = torch.as_tensor(t)
        if tiled and t.dim() == 0:
            raise ValueError("a tiled all_gather needs at least one axis")
        if world == 1:
            return t if tiled else t.unsqueeze(0)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, axis) if tiled else torch.stack(parts)

    return tree_map(gather, x)


def host_all_gather(x) -> np.ndarray:
    """Host-level gather across processes: every process's value (a numpy
    array or scalar) stacked on a new leading axis ``[process_count,
    ...]``, identical everywhere, as numpy. One process gives
    ``np.asarray(x)[None]``."""
    fire_fault_hook("host_all_gather")
    t0 = time.perf_counter()
    out = _host_all_gather(x)
    fire_observe_hook("host_all_gather", out,
                      seconds=time.perf_counter() - t0)
    return out


def _host_all_gather(x) -> np.ndarray:
    a = np.asarray(x)
    if bootstrap.process_count() == 1:
        return a[None]
    t = torch.from_numpy(np.array(a)).to(bootstrap.device_of_group())
    parts = [torch.empty_like(t) for _ in range(bootstrap.process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def host_all_reduce_sum(x) -> Any:
    """Host-level SUM across processes of a numpy array or scalar, outside
    any step: the sum over :func:`host_all_gather`'s leading axis, in
    process order (the reference's ``process_allgather(x).sum(0)``). One
    process gives ``x`` as it is."""
    fire_fault_hook("host_all_reduce_sum")
    t0 = time.perf_counter()
    out = (x if bootstrap.process_count() == 1
           else _host_all_gather(x).sum(axis=0))
    fire_observe_hook("host_all_reduce_sum", out,
                      seconds=time.perf_counter() - t0)
    return out


def broadcast_from_chief(tree: Any, *, group=None) -> Any:
    """Process 0's tree on every process (the checkpoint restore's
    fan-out, the mirrored variables' initial broadcast); with ``group``,
    the group's first process's tree on every process of the group. ``tree`` nests
    dicts, lists and tuples over numpy arrays, numpy scalars or tensors,
    the same structure, shapes and dtypes on every process. Leaves are
    packed into one flat buffer per dtype, so a tree mixing fp32
    parameters with Adam's int32 step costs one broadcast per dtype.
    Tensor leaves are written in place on their device; numpy leaves come
    back as new arrays (sent through the process group's device: the card
    under NCCL, the CPU under gloo). With one process the tree comes back
    as it is."""
    fire_fault_hook("broadcast_from_chief")
    t0 = time.perf_counter()
    out = _broadcast_from_chief(tree, group)
    fire_observe_hook("broadcast_from_chief", out,
                      seconds=time.perf_counter() - t0)
    return out


def _broadcast_from_chief(tree: Any, group=None) -> Any:
    if group_size(group) == 1:
        return tree
    leaves = tree_leaves(tree)
    wire = bootstrap.device_of_group()
    tensors = [leaf if isinstance(leaf, torch.Tensor)
               else torch.from_numpy(np.array(leaf)).to(wire)
               for leaf in leaves]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        on = same[0].device
        flat = torch.cat([t.detach().reshape(-1).to(on) for t in same])
        dist.broadcast(flat, src=group_root(group), group=group)
        offset = 0
        with torch.no_grad():
            for t in same:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n
    out = [leaf if isinstance(leaf, torch.Tensor) else
           t.cpu().numpy().reshape(np.shape(leaf))
           for leaf, t in zip(leaves, tensors)]
    return _rebuild(tree, iter(out))
