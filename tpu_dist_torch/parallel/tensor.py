"""Tensor (model) parallelism: Megatron-style sharding over a ``'model'``
mesh axis.

Counterpart of ``tpu_dist/parallel/tensor.py``. The rules are the
reference's, leaf for leaf: each parameter gets a spec by its tree path
(a tuple with one entry per dimension, an axis name or None, where the
reference has a ``PartitionSpec``):

* attention QKV projections column-parallel (heads split over ``'model'``:
  ``[d, H*dk]`` -> ``(None, 'model')``, their biases ``('model',)``), the
  output projection row-parallel (``('model', None)``);
* a Dense layer by its structural position among the Dense siblings of
  its container (:func:`_dense_ranks`): even ranks (up-projections, heads)
  column-parallel, odd ranks (down-projections) row-parallel;
* everything else (LayerNorm, embeddings, convolutions, biases of
  row-parallel layers) replicated; optimizer states inherit their
  parameter's spec by path suffix (:func:`specs_like_params`).

The reference hands the specs to GSPMD, which derives every collective
from the sharded matmuls. The port runs one process per device and keeps
on each process only its slice of each sharded leaf
(:func:`shard_model`), so the collectives are written out, as Megatron's
f and g pairs of autograd functions over the model axis's process group:

* a column-parallel layer's input: the identity forward, an all-reduce of
  its gradient backward (:class:`_CopyToModel`);
* a row-parallel layer's output: an all-reduce forward, the identity
  backward (:class:`_ReduceFromModel`), its bias added after;
* a column-parallel output that does not feed its row-parallel partner
  (the vocab head, an even-rank Dense before a non-Dense): all-gathered
  along the features, this process's slice of the gradient backward
  (:class:`_GatherFromModel`); a row-parallel layer whose input is not
  sharded takes its slice of it (:class:`_ScatterToModel`).

So the loss sees the gathered logits (the fused cross-entropy kernel the
full vocabulary, as in one process), and every replicated leaf gets the
same gradient on every process of the model axis. Attention runs on this
process's heads (``models/transformer.py``). A multi-head attention whose
heads the axis does not divide, and any leaf of a layer that cannot run
sharded (not a Dense or an attention layer), stays replicated.

:func:`shard_model` also places the stacked leaves of the pipe and expert
axes (``parallel/pipeline_parallel.py``, ``parallel/expert.py``): each
process keeps its stage's or its experts' block along the leading
dimension, and those layers run their own exchanges.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Any, Optional

import torch
import torch.distributed as dist

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.parallel.axes import EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS

#: Column-parallel attention projections (output dim = heads * key_dim).
_ATTN_COL_W = ("wq", "wk", "wv")
_ATTN_COL_B = ("bq", "bk", "bv")


# -- the rules -------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path=()):
    """``(dict-key path, leaf)`` of a tree of dicts, NamedTuples, lists and
    tuples in ``jax.tree_util``'s flatten order; only dict keys name a
    path, as the reference's ``_dict_path_names`` reads its key paths."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], path + (str(key),))
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from _walk(getattr(tree, field), path)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _walk(sub, path)
    else:
        yield path, tree


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over :func:`_walk`'s leaves, in ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), path)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path) for v in tree)
    return fn(path, tree)


def _base(name: str) -> str:
    """Layer-name key without the uniquing suffix: dense_1 -> dense."""
    head, _, tail = name.rpartition("_")
    return head if head and tail.isdigit() else name


def _name_index(layer_name: str) -> int:
    """Uniquing suffix as an integer: dense -> 0, dense_7 -> 7."""
    _, _, tail = layer_name.rpartition("_")
    return int(tail) if tail.isdigit() else 0


def _dense_ranks(params) -> dict[tuple, int]:
    """The structural position of each Dense layer among its Dense
    siblings under the same parent container, ordered by uniquing index,
    keyed by the layer's path: position within the owning chain is what
    the Megatron up/down alternation is about (the uniquing counter's
    parity says nothing once an extra Dense shifts it)."""
    siblings: dict[tuple, set[str]] = {}
    for names, _ in _walk(params):
        if len(names) >= 2 and _base(names[-2]) == "dense":
            siblings.setdefault(tuple(names[:-2]), set()).add(names[-2])
    ranks: dict[tuple, int] = {}
    for parent, layer_names in siblings.items():
        for rank, name in enumerate(sorted(layer_names, key=_name_index)):
            ranks[parent + (name,)] = rank
    return ranks


def spec_for_param(path, leaf, *, axis_name: str = MODEL_AXIS,
                   dense_rank: Optional[int] = None) -> tuple:
    """The Megatron spec of one parameter, by its path (a tuple of dict
    keys). ``dense_rank`` is the Dense layer's structural position among
    its Dense siblings (:func:`_dense_ranks`): even ranks shard
    column-parallel, odd ranks row-parallel; when absent, the uniquing
    suffix stands in. Leaves of a pipelined stack take ``('pipe',)`` and
    expert-stacked leaves ``('expert',)`` (on a mesh without those axes
    :func:`prune_indivisible` replicates them)."""
    names = tuple(path)
    if len(names) < 2:
        return ()
    if any(_base(n) == "pipelinedblocks" for n in names):
        return (PIPE_AXIS,)
    layer, pname = _base(names[-2]), names[-1]
    if layer == "mixtureofexperts":
        return () if pname == "router" else (EXPERT_AXIS,)
    if layer == "multiheadattention":
        if pname in _ATTN_COL_W:
            return (None, axis_name)
        if pname in _ATTN_COL_B:
            return (axis_name,)
        if pname == "wo":
            return (axis_name, None)
        return ()  # bo: the row-parallel output's bias is replicated
    ndim = len(getattr(leaf, "shape", ()))
    if layer == "dense" and ndim in (1, 2):
        if dense_rank is None:
            dense_rank = _name_index(names[-2])
        if dense_rank % 2 == 0:
            return (None, axis_name) if ndim == 2 else (axis_name,)
        return (axis_name, None) if ndim == 2 else ()
    return ()


def tensor_parallel_specs(params, *, axis_name: str = MODEL_AXIS):
    """The spec tree of a params tree (nested dicts of arrays or tensors,
    the reference's tree layout; its shape mirrors ``params``)."""
    ranks = _dense_ranks(params)
    return _map(lambda names, leaf: spec_for_param(
        names, leaf, axis_name=axis_name,
        dense_rank=ranks.get(tuple(names[:-1]))), params)


def specs_like_params(tree, params_specs) -> Any:
    """Map a variables tree (optimizer moments, velocity, ...) onto the
    params' specs by path suffix: an optimizer state embeds the params
    tree, so a leaf whose trailing dict keys equal some parameter's full
    path inherits that parameter's spec (when the leaf has the dims the
    spec names). Everything else (step counters) is replicated."""
    from tpu_dist_torch.models.model import _flatten

    by_suffix = {tuple(name.split(".")): spec
                 for name, spec in _flatten(params_specs).items()}

    def lookup(names, leaf):
        ndim = len(getattr(leaf, "shape", ()))
        for start in range(len(names)):
            spec = by_suffix.get(names[start:])
            if spec is not None and len(spec) <= ndim:
                return spec
        return ()

    return _map(lookup, tree)


def prune_indivisible(specs, tree, mesh):
    """Replace any spec whose sharded dimension the mesh axis does not
    divide, or that names an axis the mesh does not have, with replicated
    (``()``): placement must mirror the leaf, not crash the job."""
    shape = mesh.shape

    def check(spec, leaf):
        dims = tuple(getattr(leaf, "shape", ()))
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            if axis not in shape or dim >= len(dims) or dims[dim] % shape[axis]:
                return ()
        return spec

    def walk(s, t):
        if isinstance(s, dict):
            return {k: walk(v, t[k]) for k, v in s.items()}
        return check(s, t)

    return walk(specs, tree)


# -- the collectives of a sharded layer ----------------------------------------------

#: Every live :class:`ModelShard`, for :func:`_regroup_shards`.
_SHARDS: "weakref.WeakSet" = weakref.WeakSet()


def _regroup_shards() -> None:
    """After a reform brought a new process group up: point every live
    shard at its axis's new group (the old one died with the old
    clique)."""
    from tpu_dist_torch.parallel import mesh as mesh_lib

    for shard in list(_SHARDS):
        if shard.mesh is not None and shard.axis is not None:
            shard.group = mesh_lib.axis_group(shard.mesh, shard.axis)


bootstrap.on_reinitialize(_regroup_shards)


@dataclasses.dataclass(eq=False)
class ModelShard:
    """This process's place on the model axis: its process group, the
    axis's size and this process's coordinate. ``calls`` counts the
    forward and backward collectives it ran by ``(op, shape, dtype)``,
    ``seconds`` their host wall time (a gloo collective blocks the host
    until the work queued before it has ended, so that time holds the
    wait too)."""

    group: Any
    size: int
    index: int
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    seconds: float = 0.0
    #: The mesh and axis the group is of: a reform rebuilds ``group`` from
    #: them (``bootstrap.reinitialize``, :func:`_regroup_shards`).
    mesh: Any = None
    axis: Optional[str] = None

    def __post_init__(self):
        _SHARDS.add(self)

    def __deepcopy__(self, memo):
        return self

    def _count(self, op: str, t: torch.Tensor, t0: float) -> None:
        self.seconds += time.perf_counter() - t0
        self.calls[op, tuple(t.shape), str(t.dtype)] += 1

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        self._count("all_reduce", t, t0)
        return t

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts, -1)
        self._count("all_gather", t, t0)
        return out

    def _slice(self, t: torch.Tensor) -> torch.Tensor:
        per = t.shape[-1] // self.size
        return t.narrow(-1, self.index * per, per).contiguous()

    def copy(self, x):
        return _CopyToModel.apply(x, self)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self)

    def gather(self, x):
        return _GatherFromModel.apply(x, self)

    def scatter(self, x):
        return _ScatterToModel.apply(x, self)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the sum of every
    process's gradient of the replicated input."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum of the partial outputs forward; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return shard._all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The features of every process's slice, concatenated in axis order;
    backward, this process's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._slice(g), None


class _ScatterToModel(torch.autograd.Function):
    """This process's slice of the features of a replicated input;
    backward, every process's slice of the gradient gathered."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard._slice(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_gather(g), None


@dataclasses.dataclass(eq=False)
class DenseShard:
    """A Dense layer's part on this process: ``mode`` is ``"col"`` (a
    column slice whose output feeds the row-parallel partner, kept
    sharded), ``"col_gather"`` (a column slice gathered after), ``"row"``
    (a row slice of a sharded input) or ``"row_scatter"`` (a row slice
    of a replicated input)."""

    shard: ModelShard
    mode: str

    def __deepcopy__(self, memo):
        return self

    def __call__(self, layer, x):
        from tpu_dist_torch.models.layers import _activation

        mode, shard = self.mode, self.shard
        if mode.startswith("col"):
            x = shard.copy(x)
        elif mode == "row_scatter":
            x = shard.scatter(x)
        y = x @ layer.kernel.to(x.dtype)
        if mode.startswith("row"):
            y = shard.reduce(y)
        if layer.use_bias:
            y = y + layer.bias.to(y.dtype)
        if mode == "col_gather":
            y = shard.gather(y)
        return _activation(layer.activation)(y)


# -- applying the rules ------------------------------------------------------------

def shard_model(model, mesh, *, axis_name: str = MODEL_AXIS) -> dict:
    """Keep on this process its slice of every leaf
    :func:`tensor_parallel_specs` shards (after :func:`prune_indivisible`)
    and wire each sharded layer's collectives (module docstring); then
    :func:`_shard_stacked` for the pipe and expert axes. The parameters
    stay the same ``nn.Parameter`` objects, their data replaced by the
    slice. Returns and records on ``model`` the layout, ``{dotted name:
    (dim, axis size, coordinate)}``, as ``model._tensor_parallel = (the
    model axis's ModelShard or None, layout, {name: the ModelShard of the
    leaf's axis})``; a mesh whose axes beside the data axis have size 1
    changes nothing."""
    from tpu_dist_torch.models.model import _flatten, _nest
    from tpu_dist_torch.parallel import mesh as mesh_lib

    named = dict(model.named_parameters())
    layout: dict = {}
    owners: dict = {}
    shard = None
    size = mesh.shape.get(axis_name, 1)
    if size > 1:
        shard = ModelShard(mesh_lib.axis_group(mesh, axis_name), size,
                           mesh_lib.coordinate(mesh, axis_name), mesh=mesh,
                           axis=axis_name)
        tree = _nest(named.items())
        specs = _flatten(prune_indivisible(
            tensor_parallel_specs(tree, axis_name=axis_name), tree, mesh))
        _shard_model_axis(model, specs, shard, axis_name, layout)
        owners.update((n, shard) for n in layout)
    _shard_stacked(model, mesh, layout, owners)
    with torch.no_grad():
        for name, (dim, size, index) in layout.items():
            p = named[name]
            per = p.shape[dim] // size
            p.data = p.data.narrow(dim, index * per, per).clone()
    if layout:
        model._tensor_parallel = (shard, layout, owners)
    return layout


def _shard_model_axis(model, specs, shard, axis_name, layout) -> None:
    """The model axis's part of :func:`shard_model`: wire the sharded
    Dense and attention layers and record their leaves in ``layout``."""
    from tpu_dist_torch.models.layers import Dense
    from tpu_dist_torch.models.transformer import MultiHeadAttention

    size = shard.size
    owner = {}
    for prefix, m in model.named_modules():
        if isinstance(m, (Dense, MultiHeadAttention)):
            owner[m] = prefix + "." if prefix else ""

    def take(name: str) -> None:
        spec = specs[name]
        if axis_name in spec:
            layout[name] = (spec.index(axis_name), size, shard.index)

    def kernel_spec(m) -> tuple:
        return specs[owner[m] + "kernel"]

    for m, prefix in owner.items():
        if isinstance(m, MultiHeadAttention):
            if (m.num_heads % size == 0
                    and specs[prefix + "wq"] == (None, axis_name)):
                for n, _ in m.named_parameters(recurse=False):
                    take(prefix + n)
                m.shard = shard
    for parent in model.modules():
        children = list(parent.children())
        for i, m in enumerate(children):
            if not isinstance(m, Dense) or m not in owner:
                continue
            spec = kernel_spec(m)
            if spec == (None, axis_name):
                nxt = children[i + 1] if i + 1 < len(children) else None
                keep = (isinstance(nxt, Dense) and nxt in owner
                        and kernel_spec(nxt) == (axis_name, None)
                        and m.activation != "softmax")
                m.shard = DenseShard(shard, "col" if keep else "col_gather")
            elif spec == (axis_name, None):
                prev = children[i - 1] if i else None
                fed = (isinstance(prev, Dense) and prev.shard is not None
                       and prev.shard.mode == "col")
                m.shard = DenseShard(shard, "row" if fed else "row_scatter")
            else:
                continue
            for n, _ in m.named_parameters(recurse=False):
                take(owner[m] + n)


def _shard_stacked(model, mesh, layout: dict, owners: dict) -> None:
    """The pipe and expert axes' part of :func:`shard_model`: a
    ``PipelinedBlocks`` whose stage count is the pipe axis's size keeps
    its stage's ``[1, ...]`` block of every ``stages`` leaf, and a
    ``MixtureOfExperts`` on an expert axis of P processes (P dividing its
    experts) its ``[E / P, ...]`` block of every expert leaf (not the
    router): spec ``('pipe',)`` / ``('expert',)``, the reference's. Each
    such layer runs on ``mesh`` (its :attr:`mesh`)."""
    from tpu_dist_torch.parallel import mesh as mesh_lib
    from tpu_dist_torch.parallel.expert import MixtureOfExperts
    from tpu_dist_torch.parallel.pipeline_parallel import PipelinedBlocks

    groups: dict = {}
    for prefix, m in model.named_modules():
        if isinstance(m, PipelinedBlocks):
            axis, on = m.axis_name, (
                mesh.shape.get(m.axis_name, 0) == m.num_stages > 1)
        elif isinstance(m, MixtureOfExperts):
            p = mesh.shape.get(m.axis_name, 0)
            axis, on = m.axis_name, p > 1 and m.num_experts % p == 0
        else:
            continue
        if not on:
            continue
        if axis not in groups:
            groups[axis] = ModelShard(mesh_lib.axis_group(mesh, axis),
                                      mesh.shape[axis],
                                      mesh_lib.coordinate(mesh, axis),
                                      mesh=mesh, axis=axis)
        shard = groups[axis]
        for n, _ in m.named_parameters():
            if n != "router":
                name = f"{prefix}.{n}" if prefix else n
                layout[name] = (0, shard.size, shard.index)
                owners[name] = shard
        m.mesh = mesh


def gather_leaf(t: torch.Tensor, dim: int, shard: ModelShard):
    """The global tensor of this process's block ``t`` (along ``dim``) on
    every process of the model axis."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim)


def gather_params(model) -> dict[str, torch.Tensor]:
    """``{dotted name: global tensor}`` of a model's parameters, its
    sharded leaves gathered over their axes (a collective: every process
    of the mesh calls it)."""
    _, layout, owners = model._tensor_parallel or (None, {}, {})
    return {n: gather_leaf(p, layout[n][0], owners[n]) if n in layout
            else p.detach() for n, p in model.named_parameters()}


__all__ = ["DenseShard", "ModelShard", "gather_params", "prune_indivisible",
           "shard_model", "spec_for_param", "specs_like_params",
           "tensor_parallel_specs"]
