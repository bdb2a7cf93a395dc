"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ``tpu_dist/ops/flash_attention.py``. The TPU kernels it
replaces, each a CUDA C++ kernel for ``sm_90a`` built by ``ops/_build.py``
at first use and called through ``ctypes`` (design and bound in the
sources):

* ``_fwd_kernel`` (``flash_attention.py:148``, launched by ``_fwd`` at
  ``:200-240``) -> ``csrc/flash_fwd.cu``, on the tensor cores (3xTF32 for
  fp32 inputs, bf16 MMA for bf16), with a split over keys and a merge
  kernel when the grid would leave most SMs idle (:func:`split_count`);
* ``_dq_kernel`` (``:245``), ``_dkv_kernel`` (``:285``) and
  ``_dqkv_single_kernel`` (``:332``, the one-tile case) ->
  ``csrc/flash_bwd.cu``, a dK/dV kernel and a dQ kernel on the tensor cores
  (3xTF32 for fp32 inputs, bf16 MMA for bf16; the one-tile case is the same
  two kernels at that L).

Functions:

* :func:`flash_attention_fwd` — ``(O, lse)``; a CUDA tensor launches the
  kernel (or the call raises), a CPU tensor takes the plain version;
* :func:`flash_attention_bwd` — ``(dq, dk, dv)`` from the forward's
  residuals, the same device rule;
* :func:`flash_attention` — ``O`` only, the attention dispatch's call;
  differentiable through :class:`FlashAttention`, the counterpart of
  ``_flash`` with its ``jax.custom_vjp`` (``:431-450``);
* :func:`flash_attention_plain` / :func:`flash_attention_bwd_plain` — the
  same math written out in PyTorch;
* :func:`supported` — the kernels' envelope, which the wrappers enforce;
* :func:`split_count` — how many runs the forward splits each query tile's
  keys into (:func:`block_rows` query rows a tile);
* :func:`use_flash` — whether ``models/transformer.py::_default_attention``
  launches the kernels for a tensor (every CUDA tensor).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_dist_torch.ops import _build
from tpu_dist_torch.utils.graphs import count_launch

_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"
#: Head dims the kernels are instantiated for (a template parameter).
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
#: The kernels' grids put their query or key tiles (64 rows or more) on
#: grid.y (<= 65535).
MAX_LEN = 64 * 65535


def flash_attention_plain(q, k, v, *, causal: bool = False, scale: float):
    """Dense softmax attention over ``[..., L, D]`` in fp32: returns
    ``(O [..., L, D] in q's dtype, lse [..., L, 1] fp32)``."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("...qk,...kd->...qd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              scale: float):
    """The backward of :func:`flash_attention_plain` written out in fp32,
    as ``_bwd`` computes it (``tpu_dist/ops/flash_attention.py:356-425``):
    P recomputed from the saved ``lse``, δ = rowsum(dO∘O), dS = P∘(dP − δ)
    ·scale. For bf16 inputs P and dS are rounded to bf16 before their
    products, as the TPU kernels cast them. Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("...qd,...kd->...qk", dof, vf)
    ds = p * (dp - delta) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("...qk,...qd->...kd", p, dof)
    dk = torch.einsum("...qk,...qd->...kd", ds, qf)
    dq = torch.einsum("...qk,...kd->...qd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def supported(q) -> bool:
    """Whether the kernels take this shape and dtype: ``[B, H, L, D]`` with
    ``D`` in :data:`HEAD_DIMS`, fp32 or bf16, any ``1 <= L <= MAX_LEN``
    (the kernels mask the ragged last tile themselves)."""
    return (q.dim() == 4 and q.dtype in _DTYPES
            and q.shape[-1] in HEAD_DIMS and 1 <= q.shape[-2] <= MAX_LEN
            and q.shape[0] * q.shape[1] >= 1)


def use_flash(q) -> bool:
    """Whether the default attention path launches the kernels for ``q``:
    every CUDA tensor does (one the kernels do not take raises)."""
    return q.is_cuda


def block_rows(d: int) -> int:
    """Query rows one block of the forward kernel owns at head dim ``d``:
    4 warps of two 16-row tiles (128) at D <= 64, of one (64) at D = 128
    (``m_tiles`` in ``csrc/flash_fwd.cu``)."""
    return 128 if d <= 64 else 64


def split_count(bh: int, ln: int, d: int, sms: int) -> int:
    """Runs the forward splits each query tile's live keys into, for ``bh``
    instances of ``[ln, d]`` on a card with ``sms`` SMs. A grid of at least
    one block per SM is not split (the training shape's 2048 blocks). A
    smaller one (serving's prefill: 8 instances of 1-4 query tiles) is
    split into the largest power of two of runs that keeps it within one
    block per SM, and at most one run per 32-key tile: 4, 8 and 4 at
    serving's pads of 512, 256 and 128 (D = 64) on 132 SMs. (A power of two
    divides the causal tiles' even key-tile counts evenly.)"""
    blocks = bh * -(-ln // block_rows(d))
    splits = 1
    while 2 * splits * blocks <= sms and 2 * splits <= -(-ln // 32):
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(_SOURCE).tpu_dist_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = _build.load(_BWD_SOURCE).tpu_dist_flash_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _delta_kernel():
    fn = _build.load(_BWD_SOURCE).tpu_dist_flash_bwd_delta
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device} does not match q {tuple(q.shape)} {q.dtype} on "
                f"{q.device}")
    if not supported(q):
        raise ValueError(
            f"flash_attention: the kernel takes [B, H, L, D] fp32/bf16 with "
            f"D in {HEAD_DIMS} and 1 <= L <= {MAX_LEN}; got "
            f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _on_cuda(*tensors) -> bool:
    """True for all-CUDA tensors (the kernels), False for all-CPU ones
    (the plain versions); raises on anything else."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"}:
        raise ValueError(
            f"flash_attention: the tensors must all be on CUDA (kernel) or "
            f"all on the CPU (plain version); got {sorted(devices)}")
    return True


def flash_attention_fwd(q, k, v, *, causal: bool = False, scale: float):
    """Fused attention forward, ``[B, H, L, D] -> (O [B, H, L, D],
    lse [B, H, L, 1] fp32)``. CUDA tensors launch the kernel (and raise on
    anything it does not take, a non-positive ``scale`` included); CPU
    tensors take :func:`flash_attention_plain`."""
    if not _on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention: the forward kernel takes a "
                         f"positive scale; got {scale}")
    # The kernel copies tiles 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied once (fresh allocations always qualify).
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    b, h, ln, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, ln, 1), dtype=torch.float32, device=q.device)
    # A CUDA tensor's device always carries its index.
    splits = split_count(b * h, ln, q.shape[-1], _sm_count(q.device.index))
    _launch_fwd(q, k, v, o, lse, causal=causal, scale=scale, splits=splits)
    count_launch(flash_attention_fwd)
    return o, lse


#: Kernel launches since the last reset — a run reads it to show that its
#: path went through the kernel. CPU calls (the plain version) never count.
flash_attention_fwd.launches = 0


def _launch_fwd(q, k, v, o, lse, *, causal, scale, splits):
    """Launch the forward kernel (and, for ``splits > 1``, the merge
    kernel, with its workspace) on checked, 16-byte-aligned tensors; a
    benchmark may time another split count."""
    b, h, ln, d = q.shape
    part_acc = part_ml = 0
    if splits > 1:
        # One fp32 workspace: the runs' acc [splits, BH, L, D], then their
        # (m, l) pairs [splits, BH, L, 2]. Freed on return: the caching
        # allocator hands it only to work queued after the merge on this
        # stream.
        rows = splits * b * h * ln
        work = torch.empty(rows * (d + 2), dtype=torch.float32,
                           device=q.device)
        part_acc = work.data_ptr()
        part_ml = part_acc + 4 * rows * d
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), part_acc, part_ml,
                        b * h, ln, d, int(q.dtype == torch.bfloat16),
                        int(bool(causal)), float(scale), int(splits), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed with CUDA error {err} "
            f"for {tuple(q.shape)} {q.dtype} in {splits} split(s)")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        scale: float):
    """Fused attention backward: the forward's residuals ``q, k, v, o``
    ``[B, H, L, D]`` and ``lse [B, H, L, 1]`` fp32, and the output's
    gradient ``do`` -> ``(dq, dk, dv)``. CUDA tensors launch the two
    kernels of ``csrc/flash_bwd.cu`` (and raise on anything they do not
    take); CPU tensors take :func:`flash_attention_bwd_plain`. δ =
    rowsum(dO∘O), which ``_bwd`` leaves to XLA, is a small kernel of the
    same source launched first."""
    if not _on_cuda(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    o, do = o.contiguous(), do.contiguous()
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} {t.dtype} does "
                f"not match q {tuple(q.shape)} {q.dtype} on {q.device}")
    b, h, ln, d = q.shape
    if (lse.shape != (b, h, ln, 1) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(
            f"flash_attention: lse must be the forward's contiguous fp32 "
            f"[{b}, {h}, {ln}, 1]; got {tuple(lse.shape)} {lse.dtype}")
    # The kernels copy tiles 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied once (fresh allocations always qualify).
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q, k, v, o, do))
    delta = torch.empty((b, h, ln), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch_delta(do, o, delta)
    _launch_bwd(q, k, v, do, lse, delta, dq, dk, dv, causal=causal,
                scale=scale, parts=3)
    count_launch(flash_attention_bwd)
    return dq, dk, dv


def _launch_delta(do, o, delta):
    """δ = rowsum(dO∘O) into ``delta`` ``[B, H, L]`` fp32, from checked,
    16-byte-aligned ``do`` and ``o``."""
    b, h, ln, d = do.shape
    with torch.cuda.device(do.device):
        stream = torch.cuda.current_stream(do.device).cuda_stream
        err = _delta_kernel()(do.data_ptr(), o.data_ptr(), delta.data_ptr(),
                              b * h * ln, d, int(do.dtype == torch.bfloat16),
                              stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: delta kernel launch failed with CUDA error "
            f"{err} for {tuple(do.shape)} {do.dtype}")


def _launch_bwd(q, k, v, do, lse, delta, dq, dk, dv, *, causal, scale,
                parts):
    """Launch the dK/dV kernel (``parts`` bit 1) and the dQ kernel (bit 2)
    on checked, 16-byte-aligned tensors; a benchmark may time one of them
    alone."""
    b, h, ln, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, ln, d, int(q.dtype == torch.bfloat16),
            int(bool(causal)), float(scale), int(parts), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: backward kernel launch failed with CUDA error "
            f"{err} for {tuple(q.shape)} {q.dtype}")


#: Backward calls that launched the kernels since the last reset: one per
#: call, and each call launches the dK/dV kernel and the dQ kernel once.
#: CPU calls (the plain version) never count.
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable fused attention over ``[B, H, L, D]`` — the
    counterpart of ``_flash`` and its ``jax.custom_vjp``
    (``tpu_dist/ops/flash_attention.py:431-450``). The forward saves the
    JAX package's residuals ``(q, k, v, o, lse)``; the backward recomputes
    P from ``lse`` in :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, scale: float):
    """Fused attention, ``[B, H, L, D] -> [B, H, L, D]``, differentiable
    through :class:`FlashAttention`. Under ``torch.inference_mode`` (or with
    no input requiring a gradient) only the forward kernel runs."""
    return FlashAttention.apply(q, k, v, causal, scale)
