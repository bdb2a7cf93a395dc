"""Collectives: communication modes, reduce ops, the cross-process
all-reduce over a list of tensors and the chief's broadcast of a tree.

Counterpart of the part of ``tpu_dist/parallel/collectives.py`` the
reference program reaches. There, XLA compiles the step's gradient
all-reduce into the program; here the trainer calls :func:`all_reduce` on
the step's gradients once per step, packed into one flat buffer (the
reference's single end-of-step all-reduce), over the process group that
``cluster/bootstrap.py`` brought up (NCCL on CUDA, gloo on the CPU). With
one process every collective is the identity.
"""

from __future__ import annotations

import enum
import logging
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.cluster import bootstrap

logger = logging.getLogger("tpu_dist_torch.collectives")


class CollectiveCommunication(enum.Enum):
    """Communication-implementation hint — TF's ``AUTO``/``RING``/``NCCL``.
    The port's transport follows the device (NCCL on CUDA, gloo on the
    CPU), so RING and NCCL are accepted and logged, as the JAX package
    accepts and logs them, and act as AUTO."""

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
        if value in (cls.RING, cls.NCCL):
            logger.info(
                "CollectiveCommunication.%s has no effect: the port uses "
                "NCCL on CUDA and gloo on the CPU (treating as AUTO)",
                value.name)
        return value


class ReduceOp(enum.Enum):
    """Cross-replica reduction op; MEAN is SUM / group size, as in TF."""

    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"


_DIST_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MEAN: "SUM", ReduceOp.MAX: "MAX",
             ReduceOp.MIN: "MIN"}


def all_reduce(tensors: Sequence[torch.Tensor],
               op: ReduceOp | str = ReduceOp.SUM) -> Sequence[torch.Tensor]:
    """Reduce every tensor across the processes, in place, in one
    collective: the tensors (one dtype, one device) are packed into a flat
    buffer, reduced, and copied back. Returns ``tensors``."""
    op = ReduceOp(op) if not isinstance(op, ReduceOp) else op
    world = bootstrap.process_count()
    if world == 1 or not tensors:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce packs one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=getattr(dist.ReduceOp, _DIST_OPS[op]))
    if op is ReduceOp.MEAN:
        flat /= world
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for key in tree:
            _leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            _leaves(sub, out)
    else:
        out.append(tree)


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(sub, leaves) for sub in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return next(leaves)


def broadcast_from_chief(tree: Any) -> Any:
    """Process 0's tree on every process (the checkpoint restore's
    fan-out). ``tree`` nests dicts, lists and tuples over numpy arrays,
    numpy scalars or tensors, the same structure, shapes and dtypes on
    every process. Leaves are packed into one flat buffer per dtype, so a
    tree mixing fp32 parameters with Adam's int32 step costs one broadcast
    per dtype (the initial-weights broadcast of mirrored variables is one
    too). Tensor leaves are written in place on their device; numpy
    leaves come back as new arrays (sent through the process group's
    device: the card under NCCL, the CPU under gloo). With one process the
    tree comes back as it is."""
    if bootstrap.process_count() == 1:
        return tree
    leaves: list = []
    _leaves(tree, leaves)
    wire = bootstrap.device_of_group()
    tensors = [leaf if isinstance(leaf, torch.Tensor)
               else torch.from_numpy(np.array(leaf)).to(wire)
               for leaf in leaves]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        on = group[0].device
        flat = torch.cat([t.detach().reshape(-1).to(on) for t in group])
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n
    out = [leaf if isinstance(leaf, torch.Tensor) else
           t.cpu().numpy().reshape(np.shape(leaf))
           for leaf, t in zip(leaves, tensors)]
    return _rebuild(tree, iter(out))
