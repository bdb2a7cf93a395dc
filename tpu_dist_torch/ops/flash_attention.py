"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of ``tpu_dist/ops/flash_attention.py``. The TPU kernel it
replaces is ``_fwd_kernel`` (``flash_attention.py:148``, launched by
``_fwd`` at ``:210``); the port's kernel is ``csrc/flash_fwd.cu`` (CUDA C++
for ``sm_90a``, built by ``ops/_build.py`` at first use and called through
``ctypes``). Its design and what bounds it on the card are in the source.

* :func:`flash_attention_fwd` — ``(O, lse)``; a CUDA tensor launches the
  kernel (or the call raises), a CPU tensor takes the plain version;
* :func:`flash_attention` — ``O`` only, the attention dispatch's call;
* :func:`flash_attention_plain` — the dense softmax math in PyTorch;
* :func:`supported` — the kernel's envelope, which the wrapper enforces;
* :func:`use_flash` — whether ``models/transformer.py::_default_attention``
  launches the kernel for a tensor (every CUDA tensor).

The backward kernels (``_dq_kernel``, ``_dkv_kernel``,
``_dqkv_single_kernel``) come with the training slice of the port.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_dist_torch.ops import _build

_SOURCE = "flash_fwd.cu"
#: Head dims the kernel is instantiated for (a template parameter).
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
#: The kernel's grid puts the 64-row query tiles on grid.y (<= 65535).
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


def supported(q) -> bool:
    """Whether the kernel takes this shape and dtype: ``[B, H, L, D]`` with
    ``D`` in :data:`HEAD_DIMS`, fp32 or bf16, any ``1 <= L <= MAX_LEN``
    (the kernel masks the ragged last tile itself)."""
    return (q.dim() == 4 and q.dtype in _DTYPES
            and q.shape[-1] in HEAD_DIMS and 1 <= q.shape[-2] <= MAX_LEN
            and q.shape[0] * q.shape[1] >= 1)


def use_flash(q) -> bool:
    """Whether the default attention path launches the kernel for ``q``:
    every CUDA tensor does (one the kernel does not take raises)."""
    return q.is_cuda


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(_SOURCE).tpu_dist_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
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


def flash_attention_fwd(q, k, v, *, causal: bool = False, scale: float):
    """Fused attention forward, ``[B, H, L, D] -> (O [B, H, L, D],
    lse [B, H, L, 1] fp32)``. CUDA tensors launch the kernel (and raise on
    anything it does not take); CPU tensors take
    :func:`flash_attention_plain`."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if devices != {"cuda"}:
        raise ValueError(
            f"flash_attention: q, k, v must all be on CUDA (kernel) or all "
            f"on the CPU (plain version); got {sorted(devices)}")
    _check(q, k, v)
    b, h, ln, d = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, ln, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), b * h, ln, d,
                        int(q.dtype == torch.bfloat16), int(bool(causal)),
                        float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed with CUDA error {err} "
            f"for {tuple(q.shape)} {q.dtype}")
    flash_attention_fwd.launches += 1
    return o, lse


#: Kernel launches since the last reset — a run reads it to show that its
#: path went through the kernel. CPU calls (the plain version) never count.
flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = False, scale: float):
    """Fused attention, ``[B, H, L, D] -> [B, H, L, D]``."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
