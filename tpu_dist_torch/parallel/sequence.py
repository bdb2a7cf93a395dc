"""Sequence (context) parallelism: ring attention over a ``seq`` mesh
axis.

Counterpart of ``tpu_dist/parallel/sequence.py``. Each process holds a
block of the sequence, ``L / P`` positions of a context of ``L`` over an
axis of ``P`` processes; attention over the whole context is computed by
rotating the K/V blocks around the axis's processes while each process's
queries stay put, folding each block into a numerically stable online
(flash-style) accumulator, so no process holds the ``[L, L]`` scores or
the whole K/V:

* :func:`ring_attention_blocks` takes this process's ``[B, H, L / P,
  D]`` blocks of q, k and v and returns its block of the output. Sources
  strictly in a query block's future are skipped under ``causal`` (no
  matmuls); the shift runs on every process at every step but the last
  (the reference's last rotation is discarded there). A block longer than
  4096 positions is folded in chunks of 2048 (``kv_chunk``).
* The shift is a ``torch.autograd.Function`` whose backward shifts the
  cotangent the other way; every fold is recomputed in the backward pass
  (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of a
  ring step), so backward memory stays O(L / P).
* :func:`ring_attention` takes and returns the whole sequence, as the
  reference's does: inside a model the axis's processes hold the same
  rows and the whole sequence (the LM's activations are not
  sequence-sharded), so it takes this process's block of q, k and v,
  runs the ring and gathers the output along the axis. The gather's
  backward takes this process's slice of the (replicated) gradient and
  the slice's backward gathers the blocks' gradients, so every process of
  the axis gets the dense run's gradients.
  ``functools.partial(ring_attention, mesh=, axis_name="seq")`` is an
  ``attention_fn``.
* :class:`RingAttention` is the declarative form, an ``attention_fn``
  that resolves its mesh late, from the strategy scope, and serializes.

The reference's ring reaches no Pallas kernel (its folds are einsums):
the port's folds are plain PyTorch, matmuls through ``torch.matmul``.
Transport: ``parallel/p2p.py``, ``batch_isend_irecv`` on the axis's
process group. Gloo's send and receive abort the process on CUDA tensors
(ROADMAP item 10b), so a CUDA block crosses through pinned host buffers,
a named step whose calls, bytes and seconds :data:`staging` counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel import p2p
from tpu_dist_torch.parallel.axes import SEQ_AXIS

#: Within-block K/V chunking: blocks longer than the threshold fold their
#: K/V in chunks of the default size, so the live score temp is
#: ``[B, H, Lc, C]`` instead of ``[B, H, Lc, Lc]``.
_KV_CHUNK_AUTO_THRESHOLD = 4096
_KV_CHUNK_DEFAULT = 2048

#: The host staging of CUDA blocks (``calls``, ``bytes``, ``seconds``)
#: and the shifts (``shifts``), forward and backward.
staging = p2p.new_counter()


def _online_merge(m, l, acc, scores, v):
    """Fold one block of scores and values into the running (max,
    normaliser, unnormalised output) accumulator: the streaming softmax
    update. A masked entry arrives as -inf; a row whose scores so far are
    all masked keeps m = -inf and its l and acc at exactly zero (the
    shifts take 0 for its max, so no -inf - -inf)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    p = torch.exp(scores - m_safe[..., None])
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.matmul(p, v.to(p.dtype))
    return m_new, l_new, acc_new


def _fold(m, l, acc, qf, k_blk, v_blk, q_pos, kv_start, causal: bool):
    """One online-softmax fold of the scaled fp32 queries against a K/V
    slab whose global positions begin at ``kv_start``."""
    scores = torch.matmul(qf, k_blk.float().transpose(-1, -2))
    if causal:
        kv_pos = kv_start + torch.arange(k_blk.shape[2], device=qf.device)
        scores = scores.masked_fill(q_pos[:, None] < kv_pos[None, :],
                                    -math.inf)
    return _online_merge(m, l, acc, scores, v_blk)


class _RingShift(torch.autograd.Function):
    """K and V to the next process on the ring, the previous process's to
    this one; backward, the cotangents the other way."""

    @staticmethod
    def forward(ctx, ring, k, v):
        ctx.ring = ring
        return tuple(ring.exchange([k, v], ring.next, ring.prev))

    @staticmethod
    def backward(ctx, dk, dv):
        ring = ctx.ring
        dk, dv = ring.exchange([dk, dv], ring.prev, ring.next)
        return None, dk, dv


def _chunk(kv_chunk: Optional[int], lc: int) -> Optional[int]:
    """The chunk a block of ``lc`` positions folds in: an explicit one
    that divides it, else 2048 above 4096 positions when it divides, else
    none (the reference's rule)."""
    if kv_chunk is not None and (kv_chunk <= 0 or lc % kv_chunk):
        kv_chunk = None  # indivisible or degenerate: the automatic rule
    if (kv_chunk is None and lc > _KV_CHUNK_AUTO_THRESHOLD
            and lc % _KV_CHUNK_DEFAULT == 0):
        kv_chunk = _KV_CHUNK_DEFAULT
    return kv_chunk


def ring_attention_blocks(q, k, v, *, mesh, axis_name: str = SEQ_AXIS,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          batch_axis: Optional[str] = None,
                          kv_chunk: Optional[int] = None):
    """The ring on input that is already split: exact multi-head attention
    over a sequence whose blocks lie on the processes of ``axis_name``.

    Args:
      q, k, v: this process's ``[B, H, L / P, D]`` blocks, block ``i`` on
        the process at coordinate ``i`` of the axis (``sequence_sharding``
        places a global array so).
      mesh: the mesh; ``axis_name`` must be one of its axes.
      causal: an autoregressive mask over global positions.
      scale: the score scale; default ``1 / sqrt(D)``.
      batch_axis: a mesh axis sharding the batch (data parallelism beside
        the ring). The batch rows are already this process's, so it is
        only checked to be an axis of the mesh.
      kv_chunk: fold each ring step's K/V block in chunks of this many
        positions; None chunks at 2048 above 4096 positions; a chunk that
        does not divide the block falls back to that rule.

    Returns this process's ``[B, H, L / P, D]`` block of the output, in
    q's dtype. Equal (up to the fp32 summation order) to softmax attention
    on the gathered arrays, in value and gradient."""
    if k.shape != v.shape or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring_attention is self-attention: q/k/v sequence lengths must "
            f"match and k.shape == v.shape; got q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                         f"{axis_name!r}")
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                         f"{batch_axis!r}")
    size = mesh.shape[axis_name]
    me = mesh_lib.coordinate(mesh, axis_name)
    b, h, lc, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    chunk = _chunk(kv_chunk, lc)
    qf = q.float() * scale
    q_pos = me * lc + torch.arange(lc, device=q.device)
    ring = p2p._Ring.of(mesh, axis_name, staging) if size > 1 else None
    m = torch.full((b, h, lc), -math.inf, device=q.device)
    l = torch.zeros((b, h, lc), device=q.device)
    acc = torch.zeros((b, h, lc, d), device=q.device)
    k_cur, v_cur = k, v
    for t in range(size):
        src = (me - t) % size
        # A block from a strictly-future source is entirely masked: its
        # matmuls are skipped (the diagonal block, src == me, is not).
        if not (causal and src > me):
            step = chunk or lc
            for j in range(lc // step):
                start = src * lc + j * step
                k_blk = k_cur.narrow(2, j * step, step)
                v_blk = v_cur.narrow(2, j * step, step)
                m, l, acc = checkpoint(_fold, m, l, acc, qf, k_blk, v_blk,
                                       q_pos, start, causal,
                                       use_reentrant=False)
        if t < size - 1:
            k_cur, v_cur = _RingShift.apply(ring, k_cur, v_cur)
    if ring is not None and torch.is_grad_enabled():
        acc = p2p._Tie.apply(acc, k_cur, v_cur)
    # A fully masked row (not possible for causal self-attention) would
    # have l = 0; the floor keeps padding schemes from making NaNs.
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


class _SliceSeq(torch.autograd.Function):
    """This process's block of the sequence dimension (2) of a tensor its
    axis's processes hold alike; backward, every block's gradient
    gathered (each process computed its own block's)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size = group, size
        per = x.shape[2] // size
        return x.narrow(2, index * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.size), None, None, None


class _GatherSeq(torch.autograd.Function):
    """Every process's block of the sequence dimension, concatenated in
    axis order; backward, this process's block of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.size, ctx.index = size, index
        return _gather_seq(x, group, size)

    @staticmethod
    def backward(ctx, g):
        per = g.shape[2] // ctx.size
        return (g.narrow(2, ctx.index * per, per).contiguous(), None, None,
                None)


def _gather_seq(x, group, size):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 2)


def ring_attention(q, k, v, *, mesh, axis_name: str = SEQ_AXIS,
                   causal: bool = False, scale: Optional[float] = None,
                   batch_axis: Optional[str] = None,
                   kv_chunk: Optional[int] = None):
    """Exact multi-head attention over the whole sequence, split across
    the processes of ``axis_name`` for the work: the reference's
    ``ring_attention``, whose shard_map splits and joins the sequence.

    ``q``, ``k``, ``v`` are ``[B, H, L, D]`` arrays the axis's processes
    hold alike (a model's activations; the rows are this process's under a
    ``batch_axis``). Each process takes its block of the sequence, runs
    :func:`ring_attention_blocks` on it and the output's blocks are
    gathered along the axis: every process returns the whole ``[B, H, L,
    D]`` output. The gather's backward takes this process's block of the
    (replicated) gradient and the slice's backward gathers the blocks'
    gradients, so every process gets the dense run's gradients. So
    ``functools.partial(ring_attention, mesh=mesh, axis_name="seq")`` is an
    ``attention_fn``. Other arguments as :func:`ring_attention_blocks`'."""
    if k.shape != v.shape or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring_attention is self-attention: q/k/v sequence lengths must "
            f"match and k.shape == v.shape; got q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has axes {tuple(mesh.shape)}, no "
                         f"{axis_name!r}")
    size = mesh.shape[axis_name]
    if q.shape[2] % size:
        raise ValueError(
            f"sequence length {q.shape[2]} not divisible by mesh axis "
            f"{axis_name!r} size {size}")
    group = mesh_lib.axis_group(mesh, axis_name)
    index = mesh_lib.coordinate(mesh, axis_name)
    if size > 1:
        q, k, v = (_SliceSeq.apply(t, group, size, index) for t in (q, k, v))
    out = ring_attention_blocks(q, k, v, mesh=mesh, axis_name=axis_name,
                                causal=causal, scale=scale,
                                batch_axis=batch_axis, kv_chunk=kv_chunk)
    if size > 1:
        out = _GatherSeq.apply(out, group, size, index)
    return out


@dataclasses.dataclass(frozen=True)
class RingAttention:
    """:func:`ring_attention` as an ``attention_fn`` whose mesh is
    resolved late, at call time, from the innermost strategy scope (or the
    given ``mesh``, which is never serialized), so a model holding one
    saves and loads whole (``models/serialize.py``) and binds to the
    restoring job's mesh.

    A call is :func:`ring_attention` on the whole sequence with the
    spec's fields: ``RingAttention(mesh=m)(q, k, v)`` equals
    ``ring_attention(q, k, v, mesh=m)`` bit for bit. Without a ``scale``,
    ``1 / sqrt(D)``."""

    axis_name: str = SEQ_AXIS
    batch_axis: Optional[str] = None
    scale: Optional[float] = None
    kv_chunk: Optional[int] = None
    mesh: Optional[mesh_lib.Mesh] = None

    def resolve_mesh(self) -> mesh_lib.Mesh:
        if self.mesh is not None:
            return self.mesh
        from tpu_dist_torch.parallel.strategy import get_strategy

        mesh = get_strategy().mesh
        if self.axis_name not in mesh.shape:
            raise ValueError(
                f"RingAttention(axis_name={self.axis_name!r}) needs the "
                f"active strategy's mesh to carry that axis; the current "
                f"scope's mesh has axes {dict(mesh.shape)}. Enter a scope "
                f"like MultiWorkerMirroredStrategy(axis_shapes={{'data': 1, "
                f"{self.axis_name!r}: P}}).scope(), or pass mesh= "
                f"explicitly.")
        return mesh

    def __call__(self, q, k, v, *, causal: bool = False):
        return ring_attention(
            q, k, v, mesh=self.resolve_mesh(), axis_name=self.axis_name,
            causal=causal, scale=self.scale, batch_axis=self.batch_axis,
            kv_chunk=self.kv_chunk)


def sequence_sharding(mesh, *, axis_name: str = SEQ_AXIS,
                      batch_axis: Optional[str] = None, ndim: int = 4,
                      seq_dim: int = 2) -> mesh_lib.Placement:
    """The placement of an activation whose dimension ``seq_dim`` is split
    over ``axis_name`` (and the batch, dimension 0, over ``batch_axis``):
    ``sequence_sharding(mesh).place(x)`` is this process's block, the
    input :func:`ring_attention_blocks` takes."""
    spec = [None] * ndim
    spec[seq_dim] = axis_name
    if batch_axis is not None:
        spec[0] = batch_axis
    return mesh_lib.Placement(mesh, tuple(spec))


__all__ = ["RingAttention", "ring_attention", "sequence_sharding",
           "staging"]
