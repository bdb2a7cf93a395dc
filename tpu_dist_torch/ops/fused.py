"""Fused cross-entropy and optimizer updates: hand-written Hopper kernels and
their plain versions.

Counterpart of ``tpu_dist/ops/pallas_kernels.py``. The TPU kernels it
replaces, and the port's kernels (CUDA C++ for ``sm_90a``, built by
``ops/_build.py`` at first use and called through ``ctypes``; each source
states its design and what bounds it on the card):

==========================================  ==============================
TPU kernel (``pallas_kernels.py``)          port
==========================================  ==============================
``_ce_fwd_kernel`` (``:73``)                ``csrc/fused_ce.cu`` forward
``_ce_bwd_kernel`` (``:123``)               ``csrc/fused_ce.cu`` backward
``_sgd_kernel`` (``:237``)                  ``csrc/fused_sgd.cu`` mode 0
``_sgd_momentum_kernel`` (``:241``)         ``csrc/fused_sgd.cu`` modes 1-2
``_adam_kernel`` (``:359``)                 ``csrc/fused_adam.cu``
==========================================  ==============================

* :func:`fused_sparse_cross_entropy` — per-example softmax CE from logits
  and integer labels, differentiable in the logits (:class:`_FusedCE` ties
  :func:`fused_ce_fwd` to :func:`fused_ce_bwd`, the counterpart of
  ``_fused_ce.defvjp``); :func:`fused_ce_fwd_plain` and
  :func:`fused_ce_bwd_plain` compute the same math in PyTorch;
* :func:`fused_sgd_apply` — one SGD / momentum / Nesterov step over every
  parameter, in place; :func:`fused_sgd_plain` is the ``_sgd_jnp`` math
  (``:340``) leaf by leaf;
* :func:`fused_adam_apply` — one Adam step over every parameter, in place;
  :func:`fused_adam_plain` is the ``_adam_jnp`` math (``:438``).

Every wrapper takes its plain version for tensors on the CPU, and for
CUDA tensors launches its kernel or raises: nothing falls back from a CUDA
tensor. Each counts its launches in ``.launches``; CPU calls count nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from tpu_dist_torch.ops import _build

#: Elements per block of the optimizer kernels (``kChunk`` in the sources).
CHUNK = 4096

# -- fused sparse cross-entropy ----------------------------------------------

_CE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}


def fused_ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor):
    """``[B, C]`` logits x ``[B]`` labels -> fp32 ``(loss [B], lse [B])``:
    ``lse = log(sum(exp(x − max))) + max`` and ``loss = lse − x[label]``,
    the ``_ce_fwd_kernel`` math. The label's logit is picked by a column
    mask, so a label outside ``[0, C)`` picks 0 (loss = lse), as on the
    TPU and in the kernel."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)) + m
    cols = torch.arange(x.shape[-1], device=x.device)
    picked = torch.where(cols == labels.reshape(-1, 1), x, 0.0).sum(dim=-1)
    lse = lse.squeeze(-1)
    return lse - picked, lse


def fused_ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                       lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``(exp(x − lse) − onehot(label)) · g`` in fp32, returned in the
    logits' dtype — the ``_ce_bwd_kernel`` math."""
    probs = torch.exp(logits.float() - lse.reshape(-1, 1))
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols == labels.reshape(-1, 1)).float()
    return ((probs - onehot) * g.float().reshape(-1, 1)).to(logits.dtype)


def supported(logits: torch.Tensor, labels: torch.Tensor) -> bool:
    """The CE kernels' envelope: contiguous ``[B, C]`` fp32 or bf16 logits
    (any ``C >= 1``, ``1 <= B < 2**31``) and contiguous ``[B]`` int32 or
    int64 labels, all on one CUDA device."""
    return _ce_mismatch(logits, labels) is None


def _ce_mismatch(logits, labels) -> Optional[str]:
    if logits.dtype not in _CE_DTYPES:
        return f"logits must be fp32 or bf16, got {logits.dtype}"
    if labels.dtype not in _LABEL_BYTES:
        return f"labels must be int32 or int64, got {labels.dtype}"
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        return (f"expected [B, C] logits and [B] labels, got "
                f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        return "logits and labels must be contiguous"
    if not 1 <= logits.shape[0] < 2 ** 31 or logits.shape[1] < 1:
        return (f"need 1 <= B < 2**31 rows and C >= 1, got "
                f"{tuple(logits.shape)}")
    if not (logits.is_cuda and labels.is_cuda
            and logits.device == labels.device):
        return (f"logits ({logits.device}) and labels ({labels.device}) "
                f"must be on one CUDA device")
    return None


@functools.lru_cache(maxsize=None)
def _ce_kernels():
    lib = _build.load("fused_ce.cu")
    fwd, bwd = lib.tpu_dist_ce_fwd, lib.tpu_dist_ce_bwd
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fwd.argtypes = [p, i, p, i, p, p, i64, i64, p]
    bwd.argtypes = [p, i, p, i, p, p, p, i64, i64, p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_launch(err: int, name: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} (logits {tuple(shape)})")


def fused_ce_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """Forward of the fused CE: fp32 ``(loss [B], lse [B])``. CPU tensors
    take :func:`fused_ce_fwd_plain`; CUDA tensors in the envelope
    (:func:`supported`) launch ``csrc/fused_ce.cu`` once, anything else
    raises."""
    if not (logits.is_cuda or labels.is_cuda):
        return fused_ce_fwd_plain(logits, labels)
    reason = _ce_mismatch(logits, labels)
    if reason:
        raise ValueError(f"fused_ce_fwd: {reason}")
    rows, cols = logits.shape
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(logits.device):
        err = _ce_kernels()[0](
            logits.data_ptr(), _CE_DTYPES[logits.dtype], labels.data_ptr(),
            _LABEL_BYTES[labels.dtype], loss.data_ptr(), lse.data_ptr(), rows,
            cols, torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "fused_ce_fwd", logits.shape)
    fused_ce_fwd.launches += 1
    return loss, lse


def fused_ce_bwd(logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Backward of the fused CE: ``dlogits`` in the logits' dtype from the
    forward's ``lse`` and the losses' cotangent ``g`` (``[B]``, any float
    dtype and strides). CPU tensors take :func:`fused_ce_bwd_plain`; CUDA
    tensors launch ``csrc/fused_ce.cu`` once or raise."""
    if not (logits.is_cuda or labels.is_cuda):
        return fused_ce_bwd_plain(logits, labels, lse, g)
    reason = _ce_mismatch(logits, labels)
    if reason:
        raise ValueError(f"fused_ce_bwd: {reason}")
    rows, cols = logits.shape
    if lse.shape != (rows,) or g.shape != (rows,) or not (
            lse.device == g.device == logits.device):
        raise ValueError(
            f"fused_ce_bwd: lse {tuple(lse.shape)} on {lse.device} and g "
            f"{tuple(g.shape)} on {g.device} must be [{rows}] on "
            f"{logits.device}")
    lse = lse.float().contiguous()
    g = g.float().contiguous()   # the mean's cotangent arrives expanded
    dlogits = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        err = _ce_kernels()[1](
            logits.data_ptr(), _CE_DTYPES[logits.dtype], labels.data_ptr(),
            _LABEL_BYTES[labels.dtype], lse.data_ptr(), g.data_ptr(),
            dlogits.data_ptr(), rows, cols,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "fused_ce_bwd", logits.shape)
    fused_ce_bwd.launches += 1
    return dlogits


#: Kernel launches since the last reset — a run reads them to show that its
#: path went through the kernels. CPU calls (the plain versions) never count.
fused_ce_fwd.launches = 0
fused_ce_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    """The loss of :func:`fused_ce_fwd`, whose backward is
    :func:`fused_ce_bwd` on the saved logits, labels and lse."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = fused_ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_ce_bwd(logits, labels, lse, g), None


def fused_sparse_cross_entropy(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax CE from logits, differentiable in the logits.

    Rank-general as the reference (``pallas_kernels.py:208-226``): ``[..., C]``
    logits with ``[...]`` labels flatten to one ``[B, C]`` call, and the
    fp32 losses reshape back to ``[...]``."""
    lead = logits.shape[:-1]
    loss = _FusedCE.apply(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1))
    return loss.reshape(lead)


# -- optimizer updates: a leaf table per call ---------------------------------


def _leaf_table(index: int, leaves, *, caller: str, names: Sequence[str],
                width: int) -> tuple[list, int]:
    """The rows of a kernel's leaf table (``width`` addresses, 0 for a
    missing tensor, then the length and the index of the leaf's first
    chunk) and the number of chunks, checking on the way that every tensor
    is contiguous fp32 on CUDA device ``index`` with its param's shape. One
    pass, a few calls per tensor: this runs on every step."""
    rows, chunks = [], 0
    for i, leaf in enumerate(leaves):
        n, shape = leaf[0].numel(), leaf[0].shape
        for j, t in enumerate(leaf):
            if (t.dtype is not torch.float32 or t.get_device() != index
                    or not t.is_contiguous() or t.shape != shape):
                raise ValueError(_mismatch(caller, names[j], i, t, leaf[0],
                                           index))
        if n:
            rows.append((*(t.data_ptr() for t in leaf),
                         *([0] * (width - len(leaf))), n, chunks))
            chunks += -(-n // CHUNK)
    return rows, chunks


def _mismatch(caller: str, name: str, i: int, t: torch.Tensor,
              p: torch.Tensor, index: int) -> str:
    if t.get_device() != index:
        return (f"{caller}: every tensor must be on one CUDA device (kernel) "
                f"or all on the CPU (plain version); leaf {i}'s {name} is on "
                f"{t.device}, expected cuda:{index}")
    if t.shape != p.shape:
        return (f"{caller}: leaf {i}'s {name} {tuple(t.shape)} does not "
                f"match its param {tuple(p.shape)}")
    return (f"{caller}: the kernel takes contiguous fp32 tensors only; leaf "
            f"{i}'s {name} is {t.dtype}"
            f"{'' if t.is_contiguous() else ', non-contiguous'}")


def _upload(rows: list, device: torch.device) -> torch.Tensor:
    # From pageable memory without waiting: CUDA stages the rows before the
    # copy call returns, and the copy runs in stream order.
    return torch.tensor(rows, dtype=torch.int64).to(device, non_blocking=True)


# -- fused SGD ------------------------------------------------------------------


def fused_sgd_plain(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    velocity: Optional[Sequence[torch.Tensor]] = None, *,
                    learning_rate, momentum: float = 0.0,
                    nesterov: bool = False):
    """``p' = p − lr·g``; with momentum ``v' = m·v − lr·g`` and ``p' = p +
    v'`` (Nesterov: ``p' = p + m·v' − lr·g``), leaf by leaf in place — the
    ``_sgd_jnp`` math. ``learning_rate`` is a float or a 0-d tensor on the
    leaves' device (a schedule's value). Returns ``(params, velocity)``."""
    lr, m = learning_rate, float(momentum)
    with torch.no_grad():
        if m == 0.0:
            for p, g in zip(params, grads, strict=True):
                p.sub_(lr * g)
            return params, velocity
        for p, v, g in zip(params, velocity, grads, strict=True):
            v.copy_(m * v - lr * g)
            if nesterov:
                p.copy_(p + m * v - lr * g)
            else:
                p.add_(v)
    return params, velocity


@functools.lru_cache(maxsize=None)
def _sgd_kernel():
    fn = _build.load("fused_sgd.cu").tpu_dist_fused_sgd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sgd_mode(momentum: float, nesterov: bool) -> int:
    return 0 if momentum == 0.0 else (2 if nesterov else 1)


def _device_rate(learning_rate, device: torch.device) -> torch.Tensor:
    """The learning rate as one fp32 value on ``device``, where the kernel
    reads it: a float is filled in on the card, a tensor (a schedule's 0-d
    value) is cast and moved there. Either rounds to fp32 as the plain
    version's ``lr * g`` does."""
    if not torch.is_tensor(learning_rate):
        return torch.full((), float(learning_rate), dtype=torch.float32,
                          device=device)
    if learning_rate.numel() != 1:
        raise ValueError(f"fused_sgd_apply: the learning rate must be one "
                         f"value, got shape {tuple(learning_rate.shape)}")
    return learning_rate.to(device=device, dtype=torch.float32).reshape(())


def fused_sgd_apply(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    velocity: Optional[Sequence[torch.Tensor]] = None, *,
                    learning_rate, momentum: float = 0.0,
                    nesterov: bool = False):
    """One SGD step over every parameter leaf, in place; returns ``(params,
    velocity)``. ``learning_rate`` is a float or a one-element tensor (a
    schedule's value, which stays on the device: the kernel reads it
    through a pointer); ``momentum`` is a Python float; ``velocity`` is a
    list like ``params`` when ``momentum > 0``, else ``None``. CUDA leaves
    (fp32, contiguous, one device) launch ``csrc/fused_sgd.cu`` once for all
    of them and raise on anything else; CPU leaves take
    :func:`fused_sgd_plain`."""
    m = float(momentum)
    vel = list(velocity) if m != 0.0 else []
    if m != 0.0 and len(vel) != len(params):
        raise ValueError(f"fused_sgd_apply: momentum {m} needs a velocity "
                         f"per param, got {len(vel)} for {len(params)}")
    leaves = list(zip(params, grads, *([vel] if vel else []), strict=True))
    if not any(t.is_cuda for leaf in leaves for t in leaf):
        return fused_sgd_plain(params, grads, velocity,
                               learning_rate=learning_rate, momentum=m,
                               nesterov=nesterov)
    device = next(t.device for leaf in leaves for t in leaf if t.is_cuda)
    rows, chunks = _leaf_table(device.index, leaves,
                               caller="fused_sgd_apply",
                               names=("param", "grad", "velocity"), width=3)
    if not chunks:
        return params, velocity
    with torch.cuda.device(device):
        lr = _device_rate(learning_rate, device)
        table = _upload(rows, device)
        err = _sgd_kernel()(table.data_ptr(), len(rows), chunks,
                            _sgd_mode(m, nesterov), lr.data_ptr(), m,
                            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sgd_apply: kernel launch failed with CUDA error {err} "
            f"({len(leaves)} leaves, {chunks} chunks)")
    fused_sgd_apply.launches += 1
    if m != 0.0:
        fused_sgd_apply.momentum_launches += 1
    return params, velocity


#: All launches, and those of the momentum / Nesterov modes among them.
fused_sgd_apply.launches = 0
fused_sgd_apply.momentum_launches = 0

# -- fused Adam -------------------------------------------------------------------


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
def _adam_kernel():
    fn = _build.load("fused_adam.cu").tpu_dist_fused_adam
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    rows, chunks = _leaf_table(device.index, leaves,
                               caller="fused_adam_apply",
                               names=("param", "grad", "mu", "nu"), width=4)
    if not chunks:
        return params, mu, nu
    scale = scale.contiguous()
    b1, b2 = float(beta_1), float(beta_2)
    with torch.cuda.device(device):
        table = _upload(rows, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _adam_kernel()(table.data_ptr(), len(rows), chunks,
                        scale.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2,
                        float(epsilon), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_adam_apply: kernel launch failed with CUDA error {err} "
            f"({len(leaves)} leaves, {chunks} chunks)")
    fused_adam_apply.launches += 1
    return params, mu, nu


fused_adam_apply.launches = 0
