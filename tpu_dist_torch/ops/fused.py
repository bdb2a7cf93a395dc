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

import array
import ctypes
import functools
import operator
import weakref
from typing import Optional, Sequence

import torch

from tpu_dist_torch.ops import _build
from tpu_dist_torch.utils.graphs import count_launch

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
    count_launch(fused_ce_fwd)
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
    count_launch(fused_ce_bwd)
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


# -- optimizer updates: a leaf table built once -------------------------------
#
# Both optimizer kernels walk a device table with one row per non-empty leaf
# (the addresses of its param and state tensors, 0 for a missing one, the
# index of its grad, its length, the index of its first CHUNK-element chunk
# and a flag set when those tensors all start on a 16-byte boundary),
# followed by an int32 map from each chunk to its row. The grads are not in
# the table: backward hands out new grads every step, and the caching
# allocator gives them new addresses from step to step (measured on an
# H100: a fit rebuilt a table holding them on every step), so each launch
# takes the grads' addresses among its kernel parameters, and the kernel
# checks a grad's alignment itself. The table then depends only on the
# params and the state, which stay in place, so :class:`LeafTables` builds
# it once, with every check, uploads it and keeps it on the card. A later
# call launches at once on it: no host-to-device copy and no allocation, so
# the call can be captured in a CUDA graph (which then holds the grads'
# addresses of the captured call, as it holds every other operand's).
#
# Re-checked on every call, with vectorised reads (one C method mapped over
# a column): the params' and the state's addresses (the cache key) and
# column lengths, that they are the very tensor objects the table was built
# from (weak references: the cache keeps none of them alive, and a dead or
# another object misses), and the grads' dtype, device, shape (the
# params') and contiguity. Holding by construction: the params' and the
# state's dtype, device, shape and layout, checked when the table was
# built; a live tensor keeps them unless its storage is swapped (``.data
# =``, ``set_``), which moves its address, or an in-place metadata op
# (``resize_``, ``as_strided_``) reshapes it at the same address, which
# autograd refuses on a parameter that requires grad. A miss rebuilds with
# the full checks and raises what they refuse.

_F32 = frozenset({torch.float32})
_ptr = torch.Tensor.data_ptr
_dtype = operator.attrgetter("dtype")
_shape = operator.attrgetter("shape")
_contiguous = torch.Tensor.is_contiguous
_device_index = torch.Tensor.get_device
_deref = weakref.ref.__call__
#: Grads a launch takes among its kernel parameters (``kMaxGrads`` in the
#: sources: 32,000 bytes of the 32,764 that CUDA 12.1+ allows on sm_70+).
MAX_LEAVES = 4000


class _Table:
    """One built table and what a later call is checked against."""

    __slots__ = ("table", "ptr", "rows", "chunks", "leaves", "columns",
                 "kept", "shapes", "devices")

    def __init__(self, table, rows, chunks, columns, kept, shapes, index):
        self.table, self.ptr = table, table.data_ptr()
        self.rows, self.chunks = rows, chunks
        self.leaves, self.columns = len(shapes), columns
        self.kept = tuple(map(weakref.ref, kept))
        self.shapes = shapes
        self.devices = frozenset({index})

    def dead(self) -> bool:
        """Whether a tensor the table names was freed: no call can match
        it again, and no CUDA graph that captured it can replay."""
        return any(r() is None for r in self.kept)


class LeafTables:
    """The leaf tables of one fused optimizer: built on the first update
    over a set of params and state tensors, kept on their device and
    reused while the same tensors come back, whatever the grads' addresses.

    ``caller`` names the wrapper in error messages and ``names`` the
    columns (param, grad, then the state's). A fused optimizer holds one
    beside its state (never inside it, so the state keeps the reference's
    shapes). ``builds`` counts the tables built. A table stays until the
    tensors it names are freed (a CUDA graph that captured a launch reads
    it), so an optimizer holds one per set of tensors it updates."""

    def __init__(self, caller: str, names: Sequence[str]):
        self.caller, self.names = caller, tuple(names)
        self.builds = 0
        self._tables: dict[tuple, _Table] = {}
        self._rates: dict[int, tuple[float, torch.Tensor]] = {}

    def get(self, index: int, params: Sequence[torch.Tensor],
            grads: Sequence[torch.Tensor], state=()) -> _Table:
        """The table for these tensors on device ``index`` (-1: the CPU,
        where nothing launches), built and checked if none holds them."""
        kept = [*params]
        for col in state:
            kept += col
        key = tuple(map(_ptr, kept))
        t = self._tables.get(key)
        if t is not None and self._holds(t, params, grads, state, kept):
            return t
        return self._build(index, params, grads, state, kept, key)

    @staticmethod
    def _holds(t: _Table, params, grads, state, kept) -> bool:
        n = t.leaves
        return (len(params) == n and len(grads) == n
                and len(state) == t.columns
                and all(len(col) == n for col in state)
                and all(map(operator.is_, map(_deref, t.kept), kept))
                and set(map(_dtype, grads)) <= _F32
                and set(map(_device_index, grads)) <= t.devices
                and all(map(_contiguous, grads))
                and tuple(map(_shape, grads)) == t.shapes)

    def _build(self, index, params, grads, state, kept, key) -> _Table:
        if index >= 0 and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{self.caller}: no leaf table holds these tensors, and none "
                f"can be built while a CUDA graph is being captured; run one "
                f"update on them eagerly first")
        if len(params) > MAX_LEAVES:
            raise ValueError(f"{self.caller}: the kernel takes at most "
                             f"{MAX_LEAVES} leaves, got {len(params)}")
        columns = (params, grads, *state)
        width = len(self.names) - 1      # pointer columns: all but the grad
        rows, counts, chunks = [], [], 0
        for i, leaf in enumerate(zip(*columns, strict=True)):
            p = leaf[0]
            for j, t in enumerate(leaf):
                if (t.dtype is not torch.float32 or t.get_device() != index
                        or not t.is_contiguous() or t.shape != p.shape):
                    raise ValueError(_mismatch(self.caller, self.names[j], i,
                                               t, p, index))
            n = p.numel()
            if n:
                ptrs = [p.data_ptr(), *(t.data_ptr() for t in leaf[2:])]
                aligned = all(a % 16 == 0 for a in ptrs)
                rows.append((*ptrs, *([0] * (width - len(ptrs))), i, n,
                             chunks, int(aligned)))
                counts.append(-(-n // CHUNK))
                chunks += counts[-1]
        table = torch.cat([
            torch.tensor(rows, dtype=torch.int64).view(torch.int32).reshape(-1),
            torch.repeat_interleave(torch.arange(len(rows), dtype=torch.int32),
                                    torch.tensor(counts, dtype=torch.int64))])
        if index >= 0:
            # From pageable memory without waiting: CUDA stages the table
            # before the copy call returns, and the copy runs in stream order.
            table = table.to(torch.device("cuda", index), non_blocking=True)
        self._tables = {k: v for k, v in self._tables.items()
                        if not v.dead()}
        t = self._tables[key] = _Table(table, len(rows), chunks, len(state),
                                       kept, tuple(map(_shape, params)),
                                       index)
        self.builds += 1
        return t

    def rate(self, value: float, index: int) -> torch.Tensor:
        """A constant learning rate as one fp32 scalar on device ``index``,
        allocated once per device and refilled on the card (no copy from
        the host) only when the value changes."""
        value = float(value)
        held = self._rates.get(index)
        if held is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.caller}: the learning rate's device scalar cannot "
                    f"be allocated while a CUDA graph is being captured; run "
                    f"one update eagerly first")
            scalar = torch.full((), value, dtype=torch.float32,
                                device=torch.device("cuda", index))
        elif held[0] != value:
            scalar = held[1].fill_(value)
        else:
            return held[1]
        self._rates[index] = (value, scalar)
        return scalar


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the address the C
    entries take: PyTorch's own accessor for it (the one its generated
    kernels use), without building a ``torch.cuda.Stream`` on every call."""
    return torch._C._cuda_getCurrentRawStream(index)


def _grad_pointers(grads) -> array.array:
    """The grads' addresses as the C entries take them: one uint64 each,
    in leaf order (the table's rows name their grad by this index)."""
    return array.array("Q", map(_ptr, grads))


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


def _cuda_index(tensors) -> int:
    """The CUDA device index of the first CUDA tensor, or -1 for none."""
    return next((t.get_device() for t in tensors if t.is_cuda), -1)


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
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sgd_mode(momentum: float, nesterov: bool) -> int:
    return 0 if momentum == 0.0 else (2 if nesterov else 1)


def _tensor_rate(learning_rate: torch.Tensor, index: int,
                 caller: str = "fused_sgd_apply") -> torch.Tensor:
    """A schedule's rate (a one-element tensor) as one fp32 value on the
    card, where the kernel reads it; it rounds to fp32 as the plain
    version's products with it do."""
    if learning_rate.numel() != 1:
        raise ValueError(f"{caller}: the learning rate must be one value, "
                         f"got shape {tuple(learning_rate.shape)}")
    return learning_rate.to(device=torch.device("cuda", index),
                            dtype=torch.float32).reshape(())


def sgd_tables() -> LeafTables:
    """An empty table cache for :func:`fused_sgd_apply`."""
    return LeafTables("fused_sgd_apply", ("param", "grad", "velocity"))


def fused_sgd_apply(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    velocity: Optional[Sequence[torch.Tensor]] = None, *,
                    learning_rate, momentum: float = 0.0,
                    nesterov: bool = False,
                    tables: Optional[LeafTables] = None):
    """One SGD step over every parameter leaf, in place; returns ``(params,
    velocity)``. ``learning_rate`` is a float (kept on the card as one
    scalar per device) or a one-element tensor (a schedule's value, which
    stays on the device: the kernel reads it through a pointer);
    ``momentum`` is a Python float; ``velocity`` is a list like ``params``
    when ``momentum > 0``, else ``None``. ``tables`` (from
    :func:`sgd_tables`, held by the caller across steps) keeps the leaf
    table built on the first call; without it every call builds its own.
    CUDA leaves (fp32, contiguous, one device) launch ``csrc/fused_sgd.cu``
    once for all of them and raise on anything else; CPU leaves take
    :func:`fused_sgd_plain`."""
    m = float(momentum)
    vel = list(velocity) if m != 0.0 else []
    if m != 0.0 and len(vel) != len(params):
        raise ValueError(f"fused_sgd_apply: momentum {m} needs a velocity "
                         f"per param, got {len(vel)} for {len(params)}")
    index = params[0].get_device() if len(params) else -1
    if index < 0:
        index = _cuda_index([*params, *grads, *vel])
        if index < 0:
            return fused_sgd_plain(params, grads, velocity,
                                   learning_rate=learning_rate, momentum=m,
                                   nesterov=nesterov)
    tables = tables or sgd_tables()
    t = tables.get(index, params, grads, (vel,) if vel else ())
    if not t.chunks:
        return params, velocity
    with torch.cuda.device(index):
        lr = (_tensor_rate(learning_rate, index)
              if torch.is_tensor(learning_rate)
              else tables.rate(learning_rate, index))
        gptrs = _grad_pointers(grads)
        err = _sgd_kernel()(t.ptr, t.rows, t.chunks, _sgd_mode(m, nesterov),
                            lr.data_ptr(), m, gptrs.buffer_info()[0],
                            len(gptrs), _raw_stream(index))
    if err != 0:
        raise RuntimeError(
            f"fused_sgd_apply: kernel launch failed with CUDA error {err} "
            f"({t.leaves} leaves, {t.chunks} chunks)")
    count_launch(fused_sgd_apply)
    if m != 0.0:
        count_launch(fused_sgd_apply, "momentum_launches")
    return params, velocity


#: All launches, and those of the momentum / Nesterov modes among them.
fused_sgd_apply.launches = 0
fused_sgd_apply.momentum_launches = 0

# -- fused Adam -------------------------------------------------------------------


def fused_adam_plain(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     *, step: torch.Tensor, learning_rate,
                     beta_1: float = 0.9, beta_2: float = 0.999,
                     epsilon: float = 1e-7):
    """``m' = b1 m + (1-b1) g; v' = b2 v + (1-b2) g²; p' = p − scale m' /
    (√v' + ε)`` leaf by leaf, in place, with the bias-corrected step size
    ``scale = lr·sqrt(1 − b2^t)/(1 − b1^t)`` computed in fp32 from ``step``
    (``t``, the 0-d int32 count of updates including this one) and
    ``learning_rate`` (a float or a schedule's 0-d tensor), on the step's
    device. Returns ``(params, mu, nu)``."""
    b1, b2, eps = float(beta_1), float(beta_2), float(epsilon)
    with torch.no_grad():
        t = step.to(torch.float32)
        scale = learning_rate * torch.sqrt(1 - torch.pow(b2, t)) / (
            1 - torch.pow(b1, t))
        for p, g, m, v in zip(params, grads, mu, nu, strict=True):
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * torch.square(g))
            p.copy_(p - scale * m / (torch.sqrt(v) + eps))
    return params, mu, nu


@functools.lru_cache(maxsize=None)
def _adam_kernel():
    fn = _build.load("fused_adam.cu").tpu_dist_fused_adam
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def adam_tables() -> LeafTables:
    """An empty table cache for :func:`fused_adam_apply`."""
    return LeafTables("fused_adam_apply", ("param", "grad", "mu", "nu"))


def fused_adam_apply(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     *, step: torch.Tensor, learning_rate,
                     beta_1: float = 0.9, beta_2: float = 0.999,
                     epsilon: float = 1e-7,
                     tables: Optional[LeafTables] = None):
    """One Adam step over every parameter leaf, in place; returns
    ``(params, mu, nu)``. ``step`` is the 0-d int32 update count including
    this one, on the leaves' device, and ``learning_rate`` a float (kept on
    the card as one scalar per device) or a schedule's one-element tensor:
    the kernel reads both through pointers and computes the bias-corrected
    step size ``lr·sqrt(1 − b2^t)/(1 − b1^t)`` itself, in the plain
    version's fp32 operations, so the count never reaches the host.
    ``tables`` (from :func:`adam_tables`, held by the caller across steps)
    keeps the leaf table built on the first call; without it every call
    builds its own. CUDA leaves (fp32, contiguous) launch the kernel once
    for all of them and raise on anything else; CPU leaves take
    :func:`fused_adam_plain`."""
    kw = dict(step=step, learning_rate=learning_rate, beta_1=beta_1,
              beta_2=beta_2, epsilon=epsilon)
    if not step.is_cuda:
        if _cuda_index([*params, *grads, *mu, *nu]) >= 0:
            raise ValueError(
                f"fused_adam_apply: params, grads, moments and step must all "
                f"be on one CUDA device (kernel) or all on the CPU (plain "
                f"version); the step is on {step.device}")
        return fused_adam_plain(params, grads, mu, nu, **kw)
    if not len(params):
        raise ValueError("fused_adam_apply: no parameters")
    if step.dtype != torch.int32 or step.numel() != 1:
        raise ValueError(
            f"fused_adam_apply: step must be one int32 element; got "
            f"{tuple(step.shape)} {step.dtype}")
    index = step.get_device()
    tables = tables or adam_tables()
    t = tables.get(index, params, grads, (mu, nu))
    if not t.chunks:
        return params, mu, nu
    b1, b2 = float(beta_1), float(beta_2)
    with torch.cuda.device(index):
        lr = (_tensor_rate(learning_rate, index, "fused_adam_apply")
              if torch.is_tensor(learning_rate)
              else tables.rate(learning_rate, index))
        gptrs = _grad_pointers(grads)
        err = _adam_kernel()(t.ptr, t.rows, t.chunks, step.data_ptr(),
                             lr.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2,
                             float(epsilon), gptrs.buffer_info()[0],
                             len(gptrs), _raw_stream(index))
    if err != 0:
        raise RuntimeError(
            f"fused_adam_apply: kernel launch failed with CUDA error {err} "
            f"({t.leaves} leaves, {t.chunks} chunks)")
    count_launch(fused_adam_apply)
    return params, mu, nu


fused_adam_apply.launches = 0
