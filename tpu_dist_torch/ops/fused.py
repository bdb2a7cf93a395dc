"""Fused optimizer update: a hand-written Hopper kernel and its plain version.

Counterpart of the Adam part of ``tpu_dist/ops/pallas_kernels.py``
(``:356-447``). The TPU kernel it replaces is ``_adam_kernel``
(``pallas_kernels.py:359``, launched by ``fused_adam_apply`` at ``:425``);
the port's kernel is ``csrc/fused_adam.cu`` (CUDA C++ for ``sm_90a``, built
by ``ops/_build.py`` at first use and called through ``ctypes``). Its
design and what bounds it on the card are in the source.

* :func:`fused_adam_apply` — one Adam step over every parameter, in place;
  CUDA tensors launch the kernel once for all of them (or the call
  raises), CPU tensors take the plain version;
* :func:`fused_adam_plain` — the same math leaf by leaf in PyTorch, the
  ``_adam_jnp`` math (``pallas_kernels.py:438``).

The fused cross-entropy pair and fused SGD join this module with the
MNIST-CNN slice of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tpu_dist_torch.ops import _build

_SOURCE = "fused_adam.cu"
#: Elements per block of the kernel (``kChunk`` in the source).
CHUNK = 4096


def fused_adam_plain(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     *, scale, beta_1: float = 0.9, beta_2: float = 0.999,
                     epsilon: float = 1e-7):
    """``m' = b1 m + (1-b1) g; v' = b2 v + (1-b2) g²; p' = p − scale m' /
    (√v' + ε)`` leaf by leaf, in place; ``scale`` is a float or a 0-d
    tensor on the leaves' device. Returns ``(params, mu, nu)``."""
    b1, b2, eps = float(beta_1), float(beta_2), float(epsilon)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu, strict=True):
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * torch.square(g))
            p.copy_(p - scale * m / (torch.sqrt(v) + eps))
    return params, mu, nu


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load(_SOURCE).tpu_dist_fused_adam
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _leaf_table(index: int, leaves) -> tuple[list, int]:
    """The rows of the kernel's leaf table (p, g, m, v addresses, the
    length, the index of the leaf's first chunk) and the number of chunks,
    checking on the way that every tensor is contiguous fp32 on CUDA device
    ``index`` with its param's shape. One pass, a few calls per tensor:
    this runs on every step."""
    rows, chunks = [], 0
    for i, leaf in enumerate(leaves):
        n, shape = leaf[0].numel(), leaf[0].shape
        for j, t in enumerate(leaf):
            if (t.dtype is not torch.float32 or t.get_device() != index
                    or not t.is_contiguous() or t.shape != shape):
                raise ValueError(_mismatch(i, j, t, leaf[0], index))
        if n:
            rows.append((leaf[0].data_ptr(), leaf[1].data_ptr(),
                         leaf[2].data_ptr(), leaf[3].data_ptr(), n, chunks))
            chunks += -(-n // CHUNK)
    return rows, chunks


def _mismatch(i: int, j: int, t: torch.Tensor, p: torch.Tensor,
              index: int) -> str:
    name = ("param", "grad", "mu", "nu")[j]
    if t.get_device() != index:
        return (f"fused_adam_apply: params, grads, moments and scale must "
                f"all be on one CUDA device (kernel) or all on the CPU "
                f"(plain version); leaf {i}'s {name} is on {t.device}, the "
                f"scale on cuda:{index}")
    if t.shape != p.shape:
        return (f"fused_adam_apply: leaf {i}'s {name} {tuple(t.shape)} "
                f"does not match its param {tuple(p.shape)}")
    return (f"fused_adam_apply: the kernel takes contiguous fp32 tensors "
            f"only; leaf {i}'s {name} is {t.dtype}"
            f"{'' if t.is_contiguous() else ', non-contiguous'}")


def fused_adam_apply(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     *, scale: torch.Tensor, beta_1: float = 0.9,
                     beta_2: float = 0.999, epsilon: float = 1e-7):
    """One Adam step over every parameter leaf, in place; returns
    ``(params, mu, nu)``. ``scale`` is the bias-corrected step size
    ``lr·sqrt(1 − b2^t)/(1 − b1^t)`` as a one-element fp32 tensor on the
    leaves' device: the kernel reads it through its pointer, so the step
    count never reaches the host. CUDA leaves (fp32, contiguous) launch the
    kernel once for all of them and raise on anything else; CPU leaves take
    :func:`fused_adam_plain`. The leaf table is built and copied to the
    card on every call (a few KB, without waiting), so the grads may live
    at new addresses each step."""
    leaves = list(zip(params, grads, mu, nu, strict=True))
    if not (torch.is_tensor(scale) and scale.is_cuda):
        if any(t.is_cuda for leaf in leaves for t in leaf):
            raise ValueError(
                f"fused_adam_apply: params, grads, moments and scale must "
                f"all be on one CUDA device (kernel) or all on the CPU (plain "
                f"version); the scale is on "
                f"{scale.device if torch.is_tensor(scale) else 'the host'}")
        return fused_adam_plain(params, grads, mu, nu, scale=scale,
                                beta_1=beta_1, beta_2=beta_2,
                                epsilon=epsilon)
    if not leaves:
        raise ValueError("fused_adam_apply: no parameters")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(
            f"fused_adam_apply: scale must be one fp32 element; got "
            f"{tuple(scale.shape)} {scale.dtype}")
    device = scale.device
    rows, chunks = _leaf_table(device.index, leaves)
    if not chunks:
        return params, mu, nu
    scale = scale.contiguous()
    b1, b2 = float(beta_1), float(beta_2)
    with torch.cuda.device(device):
        # From pageable memory without waiting: CUDA stages the rows before
        # the copy call returns, and the copy runs in stream order.
        table = torch.tensor(rows, dtype=torch.int64).to(device,
                                                         non_blocking=True)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel()(table.data_ptr(), len(rows), chunks,
                        scale.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2,
                        float(epsilon), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adam_apply: kernel launch failed with CUDA error {err} "
            f"({len(leaves)} leaves, {chunks} chunks)")
    fused_adam_apply.launches += 1
    return params, mu, nu


#: Kernel launches since the last reset — a run reads it to show that its
#: path went through the kernel. CPU calls (the plain version) never count.
fused_adam_apply.launches = 0
