"""Expert parallelism: Mixture-of-Experts over an ``expert`` mesh axis.

Counterpart of ``tpu_dist/parallel/expert.py``, the GShard/Switch
formulation: a top-k router builds one-hot dispatch and combine tensors
``[groups, tokens, E, capacity]`` (:func:`_route`) and the layer is four
einsums around the expert FFNs, whose weights are stacked on a leading
``E`` axis. Capacity is enforced per group of the flattened batch; a
fixed ``groups`` makes routing, drops included, the same on any
topology, and an unset one adapts to the mesh (D x P). Tokens past an
expert's capacity contribute nothing (through the block's residual they
pass unchanged). The router runs in float32 whatever the policy, and the
Switch load-balance loss (``E * sum_e f_e p_e``) is the layer's state
``aux_loss``, pre-scaled by ``aux_loss_weight``; the trainer adds it to
the objective.

Under a mesh with an ``expert`` axis of P processes (P dividing E;
``parallel/tensor.shard_model`` places the layer and sets :attr:`mesh`)
each process holds E / P experts (spec ``('expert',)``; the router is
replicated). The axis's processes hold the same rows, so the layer takes
this process's slice of them (the reference shards the batch over
``(data, expert)`` inside its ``shard_map``), routes it in its own
groups, exchanges the dispatched slabs with a differentiable
``all_to_all`` over the axis (backward: the inverse exchange), runs its
experts, exchanges back and gathers the output along the axis. The
router's and the input's gradients then come from this process's tokens
only: the router's is summed over the axis (``p2p._SumGrad``) and the
input's gathered (:class:`_GatherRows`'s partner :class:`_SliceRows`),
so the replicated leaves stay equal. The auxiliary loss is averaged over
the axis (and its stored value over the data axis too).

The reference's experts and router are einsums XLA compiles: no Pallas
kernel. The port's are ``torch.einsum`` and ``torch.matmul``. A batch or
group count the mesh does not divide falls back to the local math (every
expert gathered into each process) with one warning.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_dist_torch.models.layers import Layer, _activation
from tpu_dist_torch.ops import initializers
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel import p2p
from tpu_dist_torch.parallel.axes import DATA_AXIS, EXPERT_AXIS

logger = logging.getLogger("tpu_dist_torch.expert")

#: Host seconds in the expert axis's all_to_all exchanges, forward and
#: backward, and their count.
exchanges = {"calls": 0, "seconds": 0.0}


def _route(gates, top_k: int, capacity: int):
    """Dispatch and combine tensors from router probabilities.

    ``gates``: ``[G, n, E]`` float32 router probabilities. Returns
    ``(dispatch [G, n, E, C] in gates.dtype, combine [G, n, E, C], aux
    [G])``, ``aux`` the per-group Switch load-balance loss. A token's place
    in an expert's queue is its order, slot-major (every slot-0 choice
    queues before any slot-1 choice, the GShard rule); a token past
    ``capacity`` contributes nothing (its one-hot position is all
    zeros)."""
    g, n, e = gates.shape
    # A stable descending sort: among equal gates the lower expert first,
    # as lax.top_k picks.
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros((g, e), dtype=torch.int64, device=gates.device)
    dispatch = torch.zeros((g, n, e, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    slots = torch.arange(capacity, device=gates.device)
    top1 = None
    for j in range(top_k):  # k is 1 or 2: an unrolled pair of updates
        oh = F.one_hot(idx[..., j], e)  # [G, n, E]
        if top1 is None:
            top1 = oh
        prev = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        pos = (prev * oh).sum(-1)  # [G, n]: this token's queue position
        capoh = (pos[..., None] == slots).to(gates.dtype)
        d_j = oh.to(gates.dtype)[..., None] * capoh[..., None, :]
        dispatch = dispatch + d_j
        combine = combine + d_j * vals[..., j][..., None, None]
        counts = counts + oh.sum(dim=1)
    # Switch aux loss: fraction routed (top-1) dot mean probability, x E.
    f = top1.float().mean(dim=1)  # [G, E]
    p = gates.mean(dim=1)  # [G, E]
    aux = e * (f * p).sum(-1)  # [G]
    return dispatch, combine, aux


class _SliceRows(torch.autograd.Function):
    """This process's block of the rows (dimension 0) the axis's processes
    hold alike; backward, every block's gradient gathered."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size = group, size
        per = x.shape[0] // size
        return x.narrow(0, index * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.group, ctx.size), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every process's block of the rows, concatenated in axis order;
    backward, this process's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.size, ctx.index = size, index
        return _gather_rows(x, group, size)

    @staticmethod
    def backward(ctx, g):
        per = g.shape[0] // ctx.size
        return (g.narrow(0, ctx.index * per, per).contiguous(), None, None,
                None)


def _gather_rows(x, group, size):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 0)


def _all_to_all(t, group, size: int, split_axis: int, concat_axis: int):
    """The reference's tiled ``all_to_all``: ``t``'s ``split_axis`` cut in
    ``size`` blocks, block i to the axis's process i; the blocks received
    concatenated along ``concat_axis`` in axis order."""
    t0 = time.perf_counter()
    # all_to_all_single: gloo's list form is not in every build (torch
    # 2.11's CUDA one lacks it); the blocks go stacked on a leading axis.
    ins = torch.stack(t.chunk(size, dim=split_axis))
    outs = torch.empty_like(ins)
    dist.all_to_all_single(outs, ins, group=group)
    exchanges["calls"] += 1
    exchanges["seconds"] += time.perf_counter() - t0
    return torch.cat(outs.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` forward; backward, the inverse exchange."""

    @staticmethod
    def forward(ctx, t, group, size, split_axis, concat_axis):
        ctx.args = (group, size, split_axis, concat_axis)
        return _all_to_all(t, group, size, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, size, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, group, size, concat_axis, split_axis), None,
                None, None, None)


class _MeanOver(torch.autograd.Function):
    """The mean over the axis's processes; backward, this process's share
    of the gradient (every process's loss holds the same mean)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None


class MixtureOfExperts(Layer):
    """Switch/GShard MoE FFN on a ``[B, L, d]`` stream.

    ``num_experts`` two-layer FFNs (d -> ff_dim -> d, ``activation``
    between) with a ``top_k`` softmax router. On an expert mesh (module
    docstring) the experts shard and tokens travel by ``all_to_all``;
    anywhere else the same stacked weights run the same einsum math
    locally. Inside ``PipelinedBlocks`` it is rejected by the stateless
    check (the aux loss is state a pipeline cannot thread)."""

    def __init__(self, num_experts: int = 8, ff_dim: int = 0,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 groups: Optional[int] = None, activation: str = "gelu",
                 axis_name: str = EXPERT_AXIS,
                 kernel_initializer: str = "glorot_uniform",
                 aux_loss_weight: float = 0.01):
        super().__init__()
        self.num_experts = num_experts
        self.ff_dim = ff_dim
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.groups = groups
        self.activation = activation
        self.axis_name = axis_name
        self.kernel_initializer = kernel_initializer
        self.aux_loss_weight = aux_loss_weight
        #: The mesh this layer's experts are placed on (None: all here).
        self.mesh = None
        #: The last forward's pre-scaled auxiliary loss with its autograd
        #: graph (the trainer adds it to the objective).
        self._aux_loss: Optional[torch.Tensor] = None
        self._warned = False

    def init(self, gen, in_shape):
        if self.ff_dim <= 0:
            raise ValueError("MixtureOfExperts needs ff_dim > 0")
        if self.top_k < 1 or self.top_k > self.num_experts:
            raise ValueError(
                f"top_k {self.top_k} outside [1, {self.num_experts}]")
        d = in_shape[-1]
        e, f = self.num_experts, self.ff_dim
        mk = initializers.get(self.kernel_initializer)
        router = mk(gen, (d, e)).float()
        w1 = torch.stack([mk(gen, (d, f)) for _ in range(e)])
        w2 = torch.stack([mk(gen, (f, d)) for _ in range(e)])
        self._set_params(router=router, w1=w1, b1=torch.zeros(e, f),
                         w2=w2, b2=torch.zeros(e, d))
        self._set_state(aux_loss=torch.zeros(()))
        return tuple(in_shape)

    # -- core math (the local path and the sharded one) -------------------

    def _expert_ffn(self, w1, b1, w2, b2, xin):
        """``[G, E_local, C, d]`` through this process's experts."""
        act = _activation(self.activation)
        dt = xin.dtype
        h = torch.einsum("gecd,edf->gecf", xin, w1.to(dt)) \
            + b1.to(dt)[None, :, None, :]
        h = act(h)
        return torch.einsum("gecf,efd->gecd", h, w2.to(dt)) \
            + b2.to(dt)[None, :, None, :]

    def _moe(self, router, experts, x_tokens, n_groups: int, a2a=None):
        """``x_tokens``: ``[n, d]``, this process's (or every) token.
        ``a2a(t, split_axis, concat_axis)`` exchanges over the expert axis
        (None: every expert here). Returns ``(y [n, d], aux)``."""
        n_dev, d = x_tokens.shape
        e, k = self.num_experts, self.top_k
        n_g = n_dev // n_groups
        xg = x_tokens.reshape(n_groups, n_g, d)
        capacity = max(1, math.ceil(self.capacity_factor * k * n_g / e))
        gates = torch.softmax(xg.float() @ router.float(), dim=-1)
        dispatch, combine, aux = _route(gates, k, capacity)
        dispatch = dispatch.to(xg.dtype)
        combine = combine.to(xg.dtype)
        xin = torch.einsum("gnec,gnd->gecd", dispatch, xg)  # [G, E, C, d]
        if a2a is not None:
            # Tokens to their experts: E split over the axis, the peers'
            # groups stacked -> [G * P, E / P, C, d].
            xin = a2a(xin, 1, 0)
        yout = self._expert_ffn(*experts, xin)
        if a2a is not None:
            yout = a2a(yout, 0, 1)  # back to the tokens' owners
        y = torch.einsum("gnec,gecd->gnd", combine, yout)
        return y.reshape(n_dev, d), aux.mean()

    # -- forward ----------------------------------------------------------

    def forward(self, x):
        lead, d = x.shape[:-1], x.shape[-1]
        n_tokens = math.prod(int(s) for s in lead)
        experts = (self.w1, self.b1, self.w2, self.b2)
        mesh = self.mesh
        if mesh is not None:
            group = mesh_lib.axis_group(mesh, self.axis_name)
            p_size = mesh.shape[self.axis_name]
            index = mesh_lib.coordinate(mesh, self.axis_name)
            d_size = mesh.shape.get(DATA_AXIS, 1)
            groups = self.groups or d_size * p_size
            shards = d_size * p_size
            # x holds this process's data rows: the reference's global
            # batch over (data, expert) is these rows over the expert axis.
            ok = (x.shape[0] % p_size == 0 and groups % shards == 0
                  and (n_tokens // p_size) % (groups // shards) == 0)
            if ok:
                return self._sharded(x, experts, group, p_size, index,
                                     groups // shards, mesh)
            if not self._warned:
                self._warned = True
                logger.warning(
                    "MixtureOfExperts: batch %d / groups %d do not divide "
                    "over data %d x expert %d; running the LOCAL fallback "
                    "despite the expert mesh", x.shape[0] * d_size, groups,
                    d_size, p_size)
            experts = tuple(p2p._GatherLeading.apply(t, group, p_size, index)
                            for t in experts)
        groups = self.groups or 1
        if n_tokens % groups:
            raise ValueError(
                f"{n_tokens} tokens not divisible into {groups} groups")
        y, aux = self._moe(self.router, experts, x.reshape(n_tokens, d),
                           groups)
        self._record_aux(aux, mesh)
        return y.reshape(*lead, d)

    def _sharded(self, x, experts, group, p_size, index, g_dev, mesh):
        d = x.shape[-1]
        x_local = _SliceRows.apply(x, group, p_size, index)
        router = self.router
        if torch.is_grad_enabled() and router.requires_grad:
            router = p2p._SumGrad.apply(router, group)

        def a2a(t, split_axis, concat_axis):
            return _AllToAll.apply(t, group, p_size, split_axis,
                                   concat_axis)

        y, aux = self._moe(router, experts, x_local.reshape(-1, d), g_dev,
                           a2a=a2a)
        aux = _MeanOver.apply(aux, group, p_size)
        self._record_aux(aux, mesh)
        return _GatherRows.apply(y.reshape(x_local.shape), group, p_size,
                                 index)

    def _record_aux(self, aux, mesh=None) -> None:
        """Keep the pre-scaled auxiliary loss for the objective and its
        value in the ``aux_loss`` buffer (averaged over the data axis on a
        mesh, as the reference's state is)."""
        self._aux_loss = self.aux_loss_weight * aux.float()
        with torch.no_grad():
            value = self._aux_loss.detach().clone()
            d_size = 1 if mesh is None else mesh.shape.get(DATA_AXIS, 1)
            if d_size > 1:
                dist.all_reduce(value, group=mesh_lib.axis_group(
                    mesh, DATA_AXIS))
                value /= d_size
            self.aux_loss.copy_(value)


__all__ = ["EXPERT_AXIS", "MixtureOfExperts"]
