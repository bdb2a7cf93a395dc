"""Point-to-point transport along a mesh axis: the ring of
``parallel/sequence.py`` and the stage handoffs of
``parallel/pipeline_parallel.py`` and ``pipeline_1f1b.py``.

The reference moves a block along an axis with ``lax.ppermute`` inside
one compiled program. Here a process sends and receives with
``batch_isend_irecv`` on the axis's process group
(``parallel/mesh.axis_group``). Gloo's send and receive abort the process
on CUDA tensors (ROADMAP item 10b), so a CUDA tensor crosses through
pinned host buffers: :func:`exchange` counts those calls, their bytes and
their seconds in the counter it is given (``sequence.staging`` for the
ring, ``pipeline_parallel.staging`` for the stage handoffs).

Autograd runs a Function's backward only when one of its outputs got a
gradient, and every process must make the same sequence of exchanges
backward as forward, or their calls part and hang. :class:`_Tie` hands
a zero gradient to transported tensors that a process does not use, so
their backward runs everywhere.

:class:`_GatherLeading` gathers a stacked leaf's blocks (a pipeline's
stages, a mixture's experts) along its leading dimension, for a layer
that falls back to running every block in each process;
:class:`_SumGrad` sums over the axis the gradient of a tensor each
process used on its own part of the work.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from tpu_dist_torch.parallel import mesh as mesh_lib


def new_counter() -> dict:
    """A staging counter: host-staged ``calls``, their ``bytes`` (both
    directions) and ``seconds``, and every exchange (``shifts``)."""
    return {"calls": 0, "bytes": 0, "seconds": 0.0, "shifts": 0}


def exchange(sends, recvs, *, group, device, counter: dict) -> list:
    """Post every send and receive at once and wait for them all.

    ``sends`` is a list of ``(tensor, peer, tag)``, ``recvs`` of
    ``((shape, dtype), peer, tag)``; peers are global ranks, and a receive
    matches the peer's send of the same tag. Returns the received tensors
    on ``device``, in ``recvs``' order; CUDA tensors cross through pinned
    host buffers."""
    staged = device.type == "cuda"
    t0 = time.perf_counter()
    if staged:
        payload = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   .copy_(t) for t, _, _ in sends]
    else:
        payload = [t.contiguous() for t, _, _ in sends]
    outs = [torch.empty(shape, dtype=dtype, pin_memory=staged)
            for (shape, dtype), _, _ in recvs]
    ops = [dist.P2POp(dist.isend, t, peer, group, tag)
           for t, (_, peer, tag) in zip(payload, sends)]
    ops += [dist.P2POp(dist.irecv, o, peer, group, tag)
            for o, (_, peer, tag) in zip(outs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    counter["shifts"] += 1
    if staged:
        outs = [o.to(device, non_blocking=True) for o in outs]
        counter["calls"] += 1
        counter["bytes"] += sum(t.numel() * t.element_size()
                                for t in (*payload, *outs))
        counter["seconds"] += time.perf_counter() - t0
    return outs


def neighbours(mesh, axis_name: str) -> tuple:
    """``(group, coordinate, size, rank)`` of this process on the axis:
    ``rank(i)`` is the global rank of the axis's process at coordinate
    ``i``."""
    group = mesh_lib.axis_group(mesh, axis_name)
    size = mesh.shape[axis_name]
    me = mesh_lib.coordinate(mesh, axis_name)

    def rank(i):
        return dist.get_global_rank(group, i) if group is not None else i

    return group, me, size, rank


@dataclasses.dataclass(frozen=True)
class _Ring:
    """The axis's process group and this process's neighbours (global
    ranks) on it, and the counter its exchanges add to."""

    group: object
    next: int
    prev: int
    counter: dict

    @classmethod
    def of(cls, mesh, axis_name: str, counter: dict) -> "_Ring":
        group, me, size, rank = neighbours(mesh, axis_name)
        return cls(group, rank((me + 1) % size), rank((me - 1) % size),
                   counter)

    def exchange(self, tensors, to: int, frm: int) -> list:
        """Send ``tensors`` to ``to`` and receive as many from ``frm``
        (one tag each)."""
        return exchange(
            [(t, to, tag) for tag, t in enumerate(tensors)],
            [((t.shape, t.dtype), frm, tag) for tag, t in enumerate(tensors)],
            group=self.group, device=tensors[0].device,
            counter=self.counter)


class _Tie(torch.autograd.Function):
    """``out`` as it is, with a zero gradient for each of ``tensors``: the
    transported tensors a process did not use still get their backward,
    so every process makes the same sequence of exchanges."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.like))


class _GatherLeading(torch.autograd.Function):
    """Every process's block of a leaf stacked along dimension 0 over the
    axis's ``group``, concatenated in axis order; backward, this process's
    block of the gradient. Every process computes the same loss from the
    gathered leaf, so its block's gradient is already whole."""

    @staticmethod
    def forward(ctx, t, group, size, index):
        ctx.size, ctx.index = size, index
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        per = g.shape[0] // ctx.size
        return g.narrow(0, ctx.index * per, per), None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity forward; backward, the sum of every process's gradient
    over the axis's ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None
