"""Pipeline parallelism: GPipe-style stage pipelining over a ``pipe`` mesh
axis.

Counterpart of ``tpu_dist/parallel/pipeline_parallel.py``. The S stages
are identical block structures whose parameters are stacked on a leading
stage axis, ``stages.<leaf>`` of shape ``[S, ...]`` at the reference's
tree paths, so bridged weights, checkpoints and saved models carry the
same names and shapes. Under a mesh with a ``pipe`` axis of size S each
process holds one stage, the ``[1, ...]`` block of every stacked leaf
(spec ``('pipe',)``, placed by ``parallel/tensor.shard_model``); a batch
is split into M microbatches and :func:`gpipe_schedule` runs the M + S - 1
ticks, each process applying its stage to its microbatch and handing the
activation to the next stage. Anywhere else (one process, a mesh without
the axis, a checkpoint restored onto another topology) the same stacked
weights run in sequence over the stages: placement changes, math does
not.

The reference runs the schedule as one ``lax.scan`` with a ring
``ppermute`` a tick inside ``shard_map``, computing on don't-care data in
the bubble; ``jax.grad`` derives the backward pipeline. Here every process
runs the ticks eagerly and autograd derives the backward:

* a process computes only at its valid ticks (``0 <= t - s < M``) and
  exchanges only what a neighbour will use, which both sides know from
  the schedule: stage ``s`` sends to ``s + 1`` (``parallel/p2p.py``,
  pinned host buffers for CUDA tensors, counted in :data:`staging`), the
  backward of each handoff sends the cotangent the other way;
* every handoff's output is tied into the result (``p2p._Tie``), so its
  backward runs on every process in the same order, and every handoff
  takes the stage input as an anchor, so the input's gradient is complete
  only after the last exchange;
* the input's gradient arrives only on stage 0 (the others never read it):
  it is summed over the axis (``p2p._SumGrad``), so the layers
  before the pipeline get the same gradient on every process;
* the last stage's output is broadcast to the axis (:class:`_FromLast`):
  every process computes the same loss from it, so its backward hands the
  last stage the gradient once and the others none (a plain all-reduce's
  backward would hand it S times).

Dropout inside a stage draws from a generator keyed by (stage, tick) on
the pipeline and by stage on the sequential path, from a seed drawn from
the trainer's generator: stochastic runs match across topologies in
distribution, not bit for bit, as in the reference. The reference reaches
no Pallas kernel here; each stage runs the port's layers, so its attention
launches the flash kernels on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch.models.layers import Dropout, Layer
from tpu_dist_torch.models.model import Model, _nest, _Tree
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel import p2p
from tpu_dist_torch.parallel.axes import PIPE_AXIS

logger = logging.getLogger("tpu_dist_torch.pipeline")

#: The host staging of CUDA activations between stages (``calls``,
#: ``bytes``, ``seconds``) and every handoff (``shifts``), forward and
#: backward.
staging = p2p.new_counter()


def _seed(base: int, *keys: int) -> int:
    """A generator seed from ``base`` and ``keys`` (the reference's
    ``fold_in``)."""
    state = np.random.SeedSequence([base % 2**63, *keys]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


class _Link:
    """This process's place on the pipe axis: its group, stage, the stage
    count and its neighbours' global ranks (None past either end)."""

    def __init__(self, mesh, axis_name: str, device):
        group, me, size, rank = p2p.neighbours(mesh, axis_name)
        self.group, self.stage, self.size, self.device = (group, me, size,
                                                          device)
        self.prev = rank(me - 1) if me > 0 else None
        self.next = rank(me + 1) if me < size - 1 else None
        self.last = rank(size - 1)

    def exchange(self, sends, recvs) -> list:
        return p2p.exchange(sends, recvs, group=self.group,
                            device=self.device, counter=staging)


class _Handoff(torch.autograd.Function):
    """``y`` (or nothing) to the next stage, the previous stage's
    activation of shape ``like`` (or nothing) to this one; backward, the
    cotangents the other way. ``anchors`` only make the output part of the
    graph (their gradient is none)."""

    @staticmethod
    def forward(ctx, link, y, like, *anchors):
        ctx.link = link
        ctx.sent = None if y is None else (y.shape, y.dtype)
        ctx.received = like is not None
        ctx.anchors = len(anchors)
        sends = [] if y is None else [(y.detach(), link.next, 0)]
        recvs = [] if like is None else [(like, link.prev, 0)]
        outs = link.exchange(sends, recvs)
        return outs[0] if outs else anchors[0].new_empty(0)

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        sends = [(g, link.prev, 0)] if ctx.received else []
        recvs = [] if ctx.sent is None else [(ctx.sent, link.next, 0)]
        outs = link.exchange(sends, recvs)
        return (None, outs[0] if outs else None, None,
                *([None] * ctx.anchors))


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every process of the axis; backward, the
    gradient to the last stage alone (every process's loss is the same
    one objective)."""

    @staticmethod
    def forward(ctx, x, link):
        ctx.mine = link.stage == link.size - 1
        out = x.contiguous().clone()
        dist.broadcast(out, link.last, group=link.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None


def gpipe_schedule(stage_apply, stage_params, x_mb, *, num_stages: int,
                   axis_name: str = PIPE_AXIS, rng: Optional[int] = None,
                   mesh=None, anchors=()):
    """The per-process GPipe loop.

    ``stage_apply(params, x, generator) -> y`` applies this process's
    stage; ``stage_params`` is its (unstacked) stage parameters; ``x_mb``
    is ``[M, mb, ...]`` microbatches (read on stage 0). At tick ``t`` stage
    ``s`` works on microbatch ``t - s`` when ``0 <= t - s < M`` and hands
    its output to stage ``s + 1``; the last stage keeps it. ``rng`` (a
    seed, or None) keys a generator per (stage, tick). ``anchors`` are
    tensors every handoff holds in the graph (module docstring). Returns
    ``[M, mb, ...]`` outputs on the last stage and zeros elsewhere, tied
    to every handoff."""
    if mesh is None:
        from tpu_dist_torch.parallel.strategy import get_strategy

        mesh = get_strategy().mesh
    link = _Link(mesh, axis_name, x_mb.device)
    if link.size != num_stages:
        raise ValueError(f"mesh axis {axis_name!r} has {link.size} "
                         f"processes, not {num_stages} stages")
    m, s = x_mb.shape[0], link.stage
    grad = torch.is_grad_enabled()
    held = [a for a in (x_mb, *anchors) if grad and a.requires_grad]
    like = (tuple(x_mb.shape[1:]), x_mb.dtype)
    recv, outs, handed = None, [], []
    for t in range(m + num_stages - 1):
        y = None
        if 0 <= t - s < m:
            gen = None
            if rng is not None:
                gen = torch.Generator(x_mb.device).manual_seed(
                    _seed(rng, s, t))
            y = stage_apply(stage_params, x_mb[t] if s == 0 else recv, gen)
            if s == num_stages - 1:
                outs.append(y)
        send = y if link.next is not None else None
        takes = link.prev is not None and 0 <= t - s + 1 < m
        if send is None and not takes:
            continue
        out = _Handoff.apply(link, send, like if takes else None,
                             *(held or [x_mb]))
        handed.append(out)
        if takes:
            recv = out
    result = torch.stack(outs) if outs else torch.zeros_like(x_mb)
    tied = [t for t in (*handed, x_mb) if t.requires_grad]
    if tied:
        result = p2p._Tie.apply(result, *tied)
    return result


def _dropouts(block) -> list:
    return [m for m in block.modules() if isinstance(m, Dropout)]


@contextlib.contextmanager
def _drawing(block, gen):
    """Every Dropout of ``block`` drawing from ``gen`` for the block."""
    drops = _dropouts(block)
    before = [m.generator for m in drops]
    for m in drops:
        m.generator = gen
    try:
        yield
    finally:
        for m, g in zip(drops, before):
            m.generator = g


class PipelinedBlocks(Layer):
    """``num_stages`` copies of ``block`` composed in sequence, with
    stage-stacked parameters that pipeline over a ``pipe`` mesh axis.

    The block must preserve its input shape (residual blocks do) and be
    stateless (no BatchNorm running statistics, no mixture-of-experts
    auxiliary loss): both are checked at init. ``microbatches`` splits
    this process's batch for the schedule; a batch it does not divide runs
    the sequential path on the pipe mesh too, with one warning.

    ``block`` is a template: it holds no parameters of the model (they
    are the stacked ``stages`` leaves) and runs each stage's slice of them
    through ``torch.func.functional_call``. On a pipe mesh
    (``parallel/tensor.shard_model`` sets :attr:`mesh`) each process holds
    its stage's ``[1, ...]`` block and runs :func:`gpipe_schedule`;
    otherwise the stages run in sequence."""

    def __init__(self, block: Optional[Layer] = None, num_stages: int = 2,
                 microbatches: int = 4, axis_name: str = PIPE_AXIS):
        super().__init__()
        # The template is no child module: its parameters are not the
        # model's.
        self.__dict__["block"] = block
        self.num_stages = num_stages
        self.microbatches = microbatches
        self.axis_name = axis_name
        #: The mesh this layer's stages are placed on (None: every stage
        #: here).
        self.mesh = None
        #: The trainer's generator; Dropout in a stage draws from seeds it
        #: gives.
        self.generator: Optional[torch.Generator] = None
        self._warned = False

    def init(self, gen, in_shape):
        if self.block is None:
            raise ValueError("PipelinedBlocks requires a block template")
        base = int(torch.randint(0, 2**62, (1,), generator=gen,
                                 device="cpu"))
        stacks: dict = {}
        for s in range(self.num_stages):
            g = torch.Generator().manual_seed(_seed(base, s))
            out_shape = self.block.init(g, tuple(in_shape))
            if tuple(out_shape) != tuple(in_shape):
                raise ValueError(
                    f"pipeline stages must preserve shape; block maps "
                    f"{tuple(in_shape)} -> {tuple(out_shape)}")
            if any(b.numel() for b in self.block.buffers()):
                # Running statistics (BatchNorm) and auxiliary losses are a
                # sequential dependency across microbatches, the very thing
                # pipelining removes (the reference's rule).
                raise ValueError(
                    "PipelinedBlocks requires stateless blocks: running "
                    "statistics (BatchNorm) are a sequential dependency "
                    "across microbatches, the very thing pipelining "
                    "removes, and would make results depend on the "
                    "microbatch size. Use LayerNormalization/GroupNorm in "
                    "pipelined stacks (what GPipe/Megatron do)")
            for name, p in self.block.named_parameters():
                stacks.setdefault(name, []).append(p.detach())
        stages = _Tree()
        Model._attach(stages, _nest(
            (n, torch.stack(v)) for n, v in stacks.items()), {})
        self.stages = stages
        # The template's own tensors are never read (every call passes a
        # stage's).
        self.block.to("meta")
        return tuple(in_shape)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.block is not None:
            self.block.train(mode)
        return self

    def _stage_apply(self, params, x, gen):
        with _drawing(self.block, gen):
            return torch.func.functional_call(self.block, params, (x,))

    def _seed_from_generator(self) -> Optional[int]:
        """A seed for the stages' Dropout, drawn from the trainer's
        generator in train mode when the block has a Dropout."""
        if not (self.training and _dropouts(self.block)):
            return None
        if self.generator is None:
            raise ValueError("Dropout needs a generator during training; "
                             "fit() hands it one")
        return int(torch.randint(0, 2**62, (1,), generator=self.generator,
                                 device=self.generator.device))

    def forward(self, x):
        stacked = dict(self.stages.named_parameters())
        mesh, rng = self.mesh, self._seed_from_generator()
        if mesh is not None:
            group = mesh_lib.axis_group(mesh, self.axis_name)
            index = mesh_lib.coordinate(mesh, self.axis_name)
            m = self.microbatches
            if x.shape[0] % m == 0:
                return self._pipelined(x, stacked, mesh, group, rng)
            if not self._warned:
                # A silent fallback on a live pipe mesh would run S times
                # slower with the 1/S memory scaling lost: say so once.
                self._warned = True
                logger.warning(
                    "PipelinedBlocks: batch %d does not divide into "
                    "microbatches %d; running the SEQUENTIAL fallback "
                    "despite the pipe mesh — resize the batch to restore "
                    "pipelining", x.shape[0], m)
            stacked = {n: p2p._GatherLeading.apply(p, group, self.num_stages,
                                                    index)
                       for n, p in stacked.items()}
        for s in range(self.num_stages):
            gen = None
            if rng is not None:
                gen = torch.Generator(x.device).manual_seed(_seed(rng, s))
            x = self._stage_apply({n: p[s] for n, p in stacked.items()}, x,
                                  gen)
        return x

    def _pipelined(self, x, stacked, mesh, group, rng):
        m = self.microbatches
        if torch.is_grad_enabled() and x.requires_grad:
            x = p2p._SumGrad.apply(x, group)
        x_mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        local = {n: p[0] for n, p in stacked.items()}
        outs = gpipe_schedule(self._stage_apply, local, x_mb,
                              num_stages=self.num_stages,
                              axis_name=self.axis_name, rng=rng, mesh=mesh,
                              anchors=tuple(stacked.values())[:1])
        link = _Link(mesh, self.axis_name, x.device)
        return _FromLast.apply(outs, link).reshape(x.shape)


__all__ = ["PIPE_AXIS", "PipelinedBlocks", "gpipe_schedule", "staging"]
