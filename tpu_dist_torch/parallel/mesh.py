"""Meshes and placements for one device per process.

Counterpart of ``tpu_dist/parallel/mesh.py``. The JAX package builds a
named ``jax.sharding.Mesh`` over every device and places arrays on it with
``NamedSharding``s. The port runs one replica per process, each on its own
device, so a mesh here is a small record: the ordered axis names and sizes
over the processes, and this process's device. A placement is a record of
a mesh and a partition spec; placing a tree puts this process's part of it
on this process's device:

* replicated (``replicate``): the whole tree, process 0's values when
  several processes start from different ones (the reference's
  initial-value broadcast of mirrored variables);
* batch-sharded (``shard_batch``): this process's contiguous rows of a
  global batch, the rows the DATA auto-shard gives it
  (``data/sharding.py``);
* any other spec (``Placement.place``): this process's block of every
  dimension the spec names an axis for, e.g. a sequence block
  (``parallel/sequence.sequence_sharding``).

The processes fill the mesh in row-major order of its axes. A mesh over
several processes with more than one axis of size > 1 gets one process
subgroup per slice of each axis (:func:`axis_group`), made once, by every
process in the same order (``torch.distributed.new_group``'s rule); an
axis spanning every process is the whole group. A reform
(``bootstrap.reinitialize``) makes them again under the new group. No process group is
started here: the mesh reads the one ``cluster/bootstrap.py`` brought up,
or none (one process).
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.parallel.axes import DATA_AXIS
from tpu_dist_torch.parallel.collectives import (broadcast_from_chief,
                                                 tree_map)
from tpu_dist_torch.utils.device import DeviceLike, resolve_device
from tpu_dist_torch.utils.errors import unported


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered ``axis_names`` with their ``sizes`` over the processes (one
    device each); ``device`` is this process's."""

    axis_names: tuple
    sizes: tuple
    device: torch.device

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and a partition spec: one entry per leading dimension, an
    axis name or None; ``()`` replicated, ``(axis,)`` the leading (batch)
    axis split over ``axis``."""

    mesh: Mesh
    spec: tuple = ()

    def place(self, tree):
        """This process's part of a tree of global arrays or tensors, as
        tensors on the mesh's device: along every dimension the spec names
        an axis for, the contiguous block its coordinate on that axis
        selects (a dimension the axis does not divide raises)."""
        def part(a):
            t = _tensor(a)
            for dim, axis in enumerate(self.spec):
                if axis is not None:
                    t = _block(t, dim, self.mesh.shape[axis],
                               coordinate(self.mesh, axis))
            return t.to(self.mesh.device)

        return tree_map(part, tree)


def make_mesh(axis_shapes: Mapping[str, int] | None = None, *,
              devices: Sequence | None = None, local: bool = False,
              device: DeviceLike = None) -> Mesh:
    """A named mesh over the processes, one device each.

    ``axis_shapes`` is an ordered ``{axis: size}``; at most one size may be
    ``-1`` (inferred, as in numpy's reshape); default ``{'data': -1}``.
    The sizes must multiply to the number of processes (``local=True``:
    this process alone). ``devices`` may name at most this process's one
    device; several devices in one process are ROADMAP item 12b.
    ``device`` follows the entry points' rule (CUDA unless ``"cpu"``); in
    a process group it defaults to the group's device."""
    if devices is not None:
        devices = list(devices)
        if len(devices) > 1:
            raise unported("a mesh over several devices in one process",
                           "12b")
        if not devices:
            raise ValueError("no devices available for mesh construction")
        device = devices[0]
    if device is None and bootstrap.is_initialized():
        device = bootstrap.group_device()
    device = resolve_device(device)
    n = 1 if local else bootstrap.process_count()
    if axis_shapes is None:
        axis_shapes = {DATA_AXIS: -1}
    axis_shapes = collections.OrderedDict(axis_shapes)
    for name, size in axis_shapes.items():
        if size != -1 and size < 1:
            raise ValueError(
                f"axis {name!r} must have size >= 1 or -1, got {size}")
    known = [s for s in axis_shapes.values() if s != -1]
    n_inferred = len(axis_shapes) - len(known)
    if n_inferred > 1:
        raise ValueError(f"at most one axis may be -1, got {dict(axis_shapes)}")
    known_prod = math.prod(known)
    if n_inferred:
        if n % known_prod:
            raise ValueError(
                f"cannot infer axis size: {n} devices not divisible by "
                f"{known_prod} ({dict(axis_shapes)})")
        axis_shapes = collections.OrderedDict(
            (k, n // known_prod if s == -1 else s)
            for k, s in axis_shapes.items())
    elif known_prod != n:
        raise ValueError(
            f"mesh shape {dict(axis_shapes)} needs {known_prod} devices, "
            f"have {n}")
    mesh = Mesh(tuple(axis_shapes), tuple(axis_shapes.values()), device)
    if not local and n > 1:
        _make_groups(mesh)
    return mesh


#: The group of an axis of size 1: this process alone, over which every
#: collective is the identity.
SELF = "self"

#: ``{(axis names, sizes, world group): {axis: group}}``: this process's
#: subgroup of each axis of every multi-process mesh made so far.
_GROUPS: dict = {}


def _slices(mesh: Mesh, k: int) -> np.ndarray:
    """The ranks of every slice of axis ``k`` (one row each, in the
    processes' row-major order)."""
    ranks = np.arange(mesh.size).reshape(mesh.sizes)
    return np.moveaxis(ranks, k, -1).reshape(-1, mesh.sizes[k])


def _make_groups(mesh: Mesh) -> None:
    """Create the subgroups of every axis of ``mesh`` once: every process
    creates every group, in axis order then slice order. An axis of size 1
    needs none (:data:`SELF`), an axis over every process is the whole
    group (None)."""
    key = (mesh.axis_names, mesh.sizes, id(dist.group.WORLD))
    if key in _GROUPS:
        return
    me = bootstrap.process_index()
    groups = {}
    for k, axis in enumerate(mesh.axis_names):
        if mesh.sizes[k] == 1:
            groups[axis] = SELF
        elif mesh.sizes[k] == mesh.size:
            groups[axis] = None
        else:
            for ranks in _slices(mesh, k):
                group = dist.new_group([int(r) for r in ranks])
                if me in ranks:
                    groups[axis] = group
    _GROUPS[key] = groups
    if (mesh.axis_names, mesh.sizes) not in _MADE:
        _MADE.append((mesh.axis_names, mesh.sizes))


#: The ``(axis names, sizes)`` of every multi-process mesh, in the order
#: their groups were made: the order every process remakes them in after
#: a reform (:func:`_remake_groups`).
_MADE: list = []


def _remake_groups() -> None:
    """After ``bootstrap.reinitialize`` brought a new process group up:
    the subgroups died with the old one, so every process makes them anew
    under the new group, in the order they were first made (the
    ``ModelShard``s that hold them are re-pointed by
    ``parallel/tensor.py``'s hook, which runs after this one)."""
    made = list(_MADE)
    _GROUPS.clear()
    _MADE.clear()
    for names, sizes in made:
        if math.prod(sizes) == bootstrap.process_count():
            _make_groups(Mesh(names, sizes, torch.device("cpu")))


bootstrap.on_reinitialize(_remake_groups)


def axis_group(mesh: Mesh, axis: str):
    """This process's group along ``axis``: the processes that share its
    coordinates on every other axis. None is the whole process group,
    :data:`SELF` this process alone (an axis of size 1, or a mesh of one
    process)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, no {axis!r}")
    if mesh.shape[axis] == 1:
        return SELF
    key = (mesh.axis_names, mesh.sizes, id(dist.group.WORLD))
    if key not in _GROUPS:
        raise ValueError(f"mesh {dict(mesh.shape)} is not over this "
                         f"process group")
    return _GROUPS[key][axis]


def replicated(mesh: Mesh) -> Placement:
    """Fully replicated: one identical copy on every process's device."""
    return Placement(mesh)


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """The leading (batch) axis split across ``axis``."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, no {axis!r}")
    return Placement(mesh, (axis,))


def coordinate(mesh: Mesh, axis: str) -> int:
    """This process's coordinate on ``axis``: the processes fill the mesh
    in row-major order of its axes, as the reference reshapes its
    process-ordered devices."""
    k = mesh.axis_names.index(axis)
    inner = math.prod(mesh.sizes[k + 1:])
    return (bootstrap.process_index() // inner) % mesh.sizes[k]


def _block(t: torch.Tensor, dim: int, shards: int, index: int):
    """Block ``index`` of ``shards`` contiguous blocks of ``t`` along
    ``dim``; a dimension the shard count does not divide raises."""
    n = t.shape[dim]
    if n % shards:
        raise ValueError(f"dimension {dim} of size {n} not divisible by "
                         f"{shards} shards")
    per = n // shards
    return t.narrow(dim, index * per, per)


def _rows(a, shards: int, index: int):
    """Shard ``index`` of ``shards`` contiguous row blocks of ``a`` (the
    DATA auto-shard's slice of a batch); a batch the shard count does not
    divide raises, as there."""
    b = a.shape[0]
    if b % shards:
        raise ValueError(
            f"global batch {b} not divisible by {shards} data shards; make "
            f"the global batch a multiple of the replica count")
    return _block(a, 0, shards, index)


def _tensor(a) -> torch.Tensor:
    return a.detach() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This process's rows of a global batch (a tree of arrays or tensors),
    as tensors on the mesh's device: the contiguous block of rows its
    coordinate on ``axis`` selects, in the DATA auto-shard's order, so the
    processes that share a data coordinate (a model or sequence axis
    beside it) hold the same rows. Dtypes are kept."""
    batch_sharded(mesh, axis)
    shards, index = mesh.shape[axis], coordinate(mesh, axis)
    return tree_map(
        lambda a: _rows(_tensor(a), shards, index).to(mesh.device), batch)


def replicate(tree, mesh: Mesh, *, broadcast: bool = False):
    """A tree of arrays or tensors as new tensors on the mesh's device;
    with ``broadcast`` in a process group, process 0's values on every
    process (``broadcast_from_chief``)."""
    placed = tree_map(lambda a: _tensor(a).to(mesh.device, copy=True), tree)
    if broadcast and bootstrap.process_count() > 1:
        broadcast_from_chief(placed)
    return placed


def place_batch(batch, device: torch.device):
    """A process-local batch (a tree of arrays or tensors) as tensors on
    ``device``, rows as they are."""
    return tree_map(lambda a: _tensor(a).to(device), batch)
