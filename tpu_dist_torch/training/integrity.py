"""Training-integrity guard: anomaly detection, SDC audits, rollback-replay.

Counterpart of ``tpu_dist/training/integrity.py``. Crash-shaped failures
(a killed worker, a torn write, a preemption) are the supervisor's; this
module catches the SEMANTIC ones that crash nothing: a NaN loss, an
exploding gradient, a flipped bit on one replica.

**In-step health vector.** An armed step computes ``f32[3] =
[nonfinite count, grad norm², update norm²]`` on the device
(:class:`StepHealth`): the parameters are copied into a persistent buffer
before the optimizer's in-place update, and ``(old − new)²`` and ``g²``
are reduced after it, with no host read. The JAX package computes the
vector in every step so that one compiled program serves armed and
unarmed fits; here an unarmed fit runs the step it ran before this module
existed (no copy, no reductions, the same launches and captured
programs). A k-step execution folds its k vectors with
:func:`reduce_window_health` (counts summed, norms maxed), inside the
captured graph on CUDA. :meth:`IntegrityGuard.on_execution` starts a
non-blocking copy of the vector into pinned host memory behind a CUDA
event and judges the PREVIOUS execution's vector, waiting only on that
execution's event: no stream synchronize a step, one execution of
detection lag. Any non-finite entry is an anomaly; the grad norm is judged
against an EMA of its own history (``spike_factor`` x EMA after
``warmup_steps`` clean executions).

**Cross-replica SDC audit.** A replica is a process (one device each).
Every ``audit_every_n`` steps each process checksums its parameters: each
leaf's bytes, as float32 (bf16 leaves widened exactly, as the JAX package
does), are summed as 32-bit words modulo 2**32 (the JAX package's uint32
wrap-sum, :func:`host_leaf_checksums` bit for bit). Each process's row of
``[n_leaves]`` checksums and its row of shard keys go through
``collectives.host_all_gather``. A leaf's shard key is this process's
coordinate on the mesh axis that shards it (model, pipe or expert;
``model._tensor_parallel``), 0 for a replicated leaf: processes with
equal keys hold the same shard and must agree, so a Megatron-sharded
leaf audits within its column block and a replicated one across every
process. The per-leaf columns name the corrupted leaf and ranks (a group
with no strict majority names every member).

**Rollback-and-replay.** A confirmed anomaly raises
:class:`RollbackAndReplay`; ``Trainer.fit`` restores the newest published
checkpoint in place (or the variables it had at the fit's start, when
none is published), rewinds the data to the epoch boundary and replays.
The epoch-keyed generator and one pass per epoch make the replay exact. A
replay that hits the same (or an earlier) step again restores strictly
older (:meth:`IntegrityGuard.rollback_plan`); past ``rollback_budget``
rollbacks :class:`IntegrityAbort` escapes ``fit`` and ``run_entry`` exits
``EXIT_INTEGRITY``.

Environment knobs (:func:`maybe_guard_from_env`), the JAX package's:

==================================  =========================================
``TPU_DIST_INTEGRITY``              ``1`` arms the guard inside ``fit``
``TPU_DIST_INTEGRITY_SPIKE``        grad-norm spike factor vs EMA (default 50)
``TPU_DIST_INTEGRITY_AUDIT_N``      SDC-audit period in steps (0 = off)
``TPU_DIST_INTEGRITY_BUDGET``       rollbacks before abort (default 3)
``TPU_DIST_INTEGRITY_QUARANTINE``   ``1`` = skip a window that already
                                    caused a rollback instead of re-running
                                    it (breaks exact replay parity)
``TPU_DIST_INTEGRITY_LOSS_SCALE``   static loss scale S: grad norms are
                                    divided by S before the spike check
``TPU_DIST_INTEGRITY_BF16_SLACK``   spike-factor multiplier when the
                                    parameters are bf16/f16 (default 4)
==================================  =========================================

The module also owns the batch-fault seam (:func:`install_batch_fault_hook`)
through which the fault injector poisons a target step's batch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger("tpu_dist_torch.integrity")

#: Fault kinds delivered through the batch seam.
BATCH_FAULT_KINDS = ("nan_loss", "grad_spike", "corrupt_batch")

INTEGRITY_ENV = "TPU_DIST_INTEGRITY"
SPIKE_ENV = "TPU_DIST_INTEGRITY_SPIKE"
AUDIT_N_ENV = "TPU_DIST_INTEGRITY_AUDIT_N"
BUDGET_ENV = "TPU_DIST_INTEGRITY_BUDGET"
QUARANTINE_ENV = "TPU_DIST_INTEGRITY_QUARANTINE"
LOSS_SCALE_ENV = "TPU_DIST_INTEGRITY_LOSS_SCALE"
BF16_SLACK_ENV = "TPU_DIST_INTEGRITY_BF16_SLACK"

_LOW_PRECISION_DTYPES = (torch.bfloat16, torch.float16)


class RollbackAndReplay(Exception):
    """A confirmed anomaly: unwind to ``fit``'s rollback handler, restore
    the last published checkpoint, replay. Never escapes ``fit``."""

    def __init__(self, kind: str, gstep: int, **detail: Any):
        self.kind = kind
        self.gstep = int(gstep)
        self.detail = detail
        super().__init__(
            f"training-integrity anomaly {kind!r} at global step {gstep}"
            + (f" ({detail})" if detail else ""))


class IntegrityAbort(Exception):
    """Rollback budget exhausted: replay is not converging. Escapes
    ``fit``; ``run_entry`` maps it to ``EXIT_INTEGRITY``."""


# -- batch-fault seam ---------------------------------------------------------

_BATCH_FAULT_HOOK = None


def install_batch_fault_hook(hook):
    """Install (or, with None, remove) the batch fault hook.

    ``hook(first_gstep, k, x, y) -> (x, y)`` is called once per execution
    with the window's first global step, its step count and its batch (a
    numpy array on the host path, a tensor on a device-resident one,
    stacked on a leading k axis for k > 1); it returns the batch to train
    on. Returns the previously installed hook."""
    global _BATCH_FAULT_HOOK
    prev = _BATCH_FAULT_HOOK
    _BATCH_FAULT_HOOK = hook
    return prev


def batch_hook_installed() -> bool:
    return _BATCH_FAULT_HOOK is not None


def fire_batch_hook(first_gstep: int, k: int, x, y):
    """Run the installed batch hook (identity when none is installed)."""
    hook = _BATCH_FAULT_HOOK
    if hook is None:
        return x, y
    return hook(first_gstep, k, x, y)


# -- in-step health vector ----------------------------------------------------

def _sumsq(tensors) -> torch.Tensor:
    """Σ x² over every element of ``tensors`` in float32, on their device
    (one multi-tensor norm pass)."""
    tensors = [t.detach().float() for t in tensors if t is not None]
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(tensors)
    return torch.stack(norms).square().sum()


def _health(loss, gsq, usq) -> torch.Tensor:
    loss = torch.as_tensor(loss).detach().float()
    bad = ((~torch.isfinite(loss)).float() + (~torch.isfinite(gsq)).float()
           + (~torch.isfinite(usq)).float())
    return torch.stack([bad.to(gsq.device), gsq, usq.to(gsq.device)])


def _leaves(tree) -> list:
    from tpu_dist_torch.models.bridge import flatten_keys

    if isinstance(tree, torch.Tensor):
        return [tree]
    return list(flatten_keys(tree).values())


def health_summary(loss, grads, params, new_params) -> torch.Tensor:
    """``f32[3] = [nonfinite_count, grad_norm², update_norm²]``, the JAX
    package's ``health_summary``, from trees (dicts, lists) of tensors:
    ``params`` before the update and ``new_params`` after it."""
    old, new = _leaves(params), _leaves(new_params)
    gsq = _sumsq(_leaves(grads))
    usq = _sumsq([n.detach().float() - o.detach().float()
                  for n, o in zip(new, old)])
    return _health(loss, gsq, usq)


def reduce_window_health(healths: torch.Tensor) -> torch.Tensor:
    """Fold a k-step execution's ``[k, 3]`` health stack into one
    ``f32[3]``: non-finite counts sum; norms take the window max."""
    return torch.stack([healths[:, 0].sum(), healths[:, 1].max(),
                        healths[:, 2].max()])


class StepHealth:
    """The armed step's health vector over the in-place optimizers:
    :meth:`before` copies the parameters into a persistent buffer (made
    once, so a captured step holds it), :meth:`after` turns the buffer
    into ``old − new`` in place and reduces it and the gradients."""

    def __init__(self, params):
        self.old = [torch.empty_like(p, memory_format=torch.preserve_format)
                    for p in params]

    def before(self, params) -> None:
        with torch.no_grad():
            torch._foreach_copy_(self.old, list(params))

    def after(self, loss, grads, params) -> torch.Tensor:
        with torch.no_grad():
            torch._foreach_sub_(self.old, list(params))
            return _health(loss, _sumsq(grads), _sumsq(self.old))


# -- cross-replica SDC audit --------------------------------------------------

def leaf_checksums(leaves) -> torch.Tensor:
    """``int64 [n_leaves]``: each leaf's float32 bytes summed as 32-bit
    words modulo 2**32, on the leaves' device. Signed and unsigned words
    agree modulo 2**32, and an int64 sum of int32 words cannot overflow
    below 2**31 elements, so the low 32 bits are the uint32 wrap-sum."""
    sums = [torch.sum(t.detach().float().reshape(-1).view(torch.int32),
                      dtype=torch.int64) for t in leaves]
    return torch.stack(sums).bitwise_and_(0xFFFFFFFF)


def host_leaf_checksums(arrays: dict) -> dict:
    """``{key: uint32 wrap-sum of the float32 bytes}`` of a ``{key:
    ndarray}`` mapping, in numpy: the JAX package's host mirror of its
    audit, which checksums pulled parameter snapshots."""
    out = {}
    for key in sorted(arrays):
        flat = np.ravel(np.asarray(arrays[key], np.float32))
        out[key] = int(flat.view(np.uint32).sum(dtype=np.uint32))
    return out


def verify_pull_checksums(arrays: dict, manifest: dict) -> None:
    """Raise :class:`IntegrityAbort` when a pulled parameter snapshot does
    not match the checksums its manifest published (transport or storage
    corruption)."""
    expected = manifest.get("checksums") or {}
    if not expected:
        return
    missing = sorted(k for k in expected if k not in arrays)
    if missing:
        raise IntegrityAbort(
            f"PS pull: snapshot v{manifest.get('version')} is missing "
            f"published leaves {missing[:4]}")
    live = host_leaf_checksums({k: arrays[k] for k in expected})
    bad = sorted(k for k in expected if live[k] != int(expected[k]))
    if bad:
        raise IntegrityAbort(
            f"PS pull: checksum mismatch on leaves {bad[:4]} of snapshot "
            f"v{manifest.get('version')} — corruption between server "
            "publish and worker read")


def named_leaves(model) -> dict:
    """``{keystr path: parameter}`` in the JAX package's flatten order of
    ``variables['params']`` (sorted keys at every level), the order
    ``bitflip``'s ``:leafK`` and the audit's columns address."""
    from tpu_dist_torch.models.bridge import flatten_keys
    from tpu_dist_torch.models.model import _nest

    return flatten_keys(_nest(model.named_parameters()))


def shard_keys(model) -> dict:
    """``{keystr path: this process's coordinate on the axis sharding the
    leaf}``, 0 for a replicated leaf (module docstring)."""
    from tpu_dist_torch.models.bridge import keypath

    tp = getattr(model, "_tensor_parallel", None)
    layout = tp[1] if tp else {}
    return {keypath(n): int(layout[n][2]) if n in layout else 0
            for n, _ in model.named_parameters()}


def _int_view(itemsize: int) -> torch.dtype:
    return {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[itemsize]


def flip_param_bit(model, *, replica: int, bit: int = 22,
                   leaf: int = 0) -> dict:
    """Inject silent data corruption: XOR one bit of element 0 of parameter
    leaf ``leaf`` (the JAX package's flatten order, :func:`named_leaves`)
    in THIS process's copy, in place (captured programs and the fused
    optimizers' leaf tables stay valid). The caller has matched the
    fault's replica to this process. ``bit`` is taken modulo the element
    width on an integer view of that width (bf16: ``22 % 16 == 6``, its
    top mantissa bit), as in the JAX package. Returns what was flipped."""
    leaves = named_leaves(model)
    names = list(leaves)
    leaf_idx = int(leaf) % len(names)
    p = leaves[names[leaf_idx]]
    width = p.element_size() * 8
    eff_bit = int(bit) % width
    mask = 1 << eff_bit
    if mask >= 1 << (width - 1):
        mask -= 1 << width  # the sign bit, in the signed view
    with torch.no_grad():
        word = p.data.reshape(-1)[:1].view(_int_view(p.element_size()))
        word.bitwise_xor_(torch.tensor(mask, dtype=word.dtype,
                                       device=word.device))
    return {"leaf": names[leaf_idx], "leaf_index": leaf_idx,
            "replica": int(replica), "device": str(p.device),
            "bit": int(bit), "effective_bit": eff_bit,
            "dtype": str(p.dtype).replace("torch.", "")}


# -- the guard ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    spike_factor: float = 50.0     # grad-norm anomaly = factor x EMA
    ema_decay: float = 0.9
    warmup_steps: int = 3          # clean executions before spike checks arm
    audit_every_n: int = 0         # SDC-audit period in global steps; 0 = off
    rollback_budget: int = 3       # rollbacks before IntegrityAbort
    quarantine: bool = False       # skip-and-log windows that caused rollback
    loss_scale: float = 1.0        # grad norms divided by this before the EMA
    bf16_spike_slack: float = 4.0  # spike-factor multiplier on bf16/f16 params

    @classmethod
    def from_env(cls) -> "IntegrityConfig":
        def _f(name, default):
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return default

        return cls(
            spike_factor=_f(SPIKE_ENV, 50.0),
            audit_every_n=int(_f(AUDIT_N_ENV, 0)),
            rollback_budget=int(_f(BUDGET_ENV, 3)),
            quarantine=os.environ.get(QUARANTINE_ENV) == "1",
            loss_scale=_f(LOSS_SCALE_ENV, 1.0),
            bf16_spike_slack=_f(BF16_SLACK_ENV, 4.0),
        )


class _HostCopy:
    """Pinned host buffers for the health vectors in flight: on CUDA a
    non-blocking copy behind an event per slot (two slots: the vector
    being judged and the one just started); on the CPU the tensor
    itself."""

    def __init__(self):
        self._slot = 0
        self._bufs: list = []
        self._events: list = []

    def start(self, health: torch.Tensor):
        if not health.is_cuda:
            return health.detach(), None
        if not self._bufs:
            self._bufs = [torch.empty(3, dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self._events = [torch.cuda.Event() for _ in range(2)]
        i, self._slot = self._slot, 1 - self._slot
        self._bufs[i].copy_(health.detach().float(), non_blocking=True)
        self._events[i].record()
        return self._bufs[i], self._events[i]

    @staticmethod
    def read(buf, event) -> np.ndarray:
        if event is not None:
            event.synchronize()
        return buf.numpy().astype(np.float64).reshape(-1)


class IntegrityGuard:
    """Per-fit integrity state machine, driven by the trainer's loop.

    Not a callback: a callback with batch hooks makes the trainer read
    every execution's loss on the host; the guard reads health one
    execution behind instead."""

    def __init__(self, config: Optional[IntegrityConfig] = None):
        self.cfg = config or IntegrityConfig()
        self._strategy = None
        self.checkpoint_dir: Optional[str] = None
        self._shard_keys: Optional[dict] = None
        #: (first_gstep, k, host buffer, event) of the newest execution:
        #: its copy is in flight; judged when the next one lands (or at
        #: flush()).
        self._pending: Optional[tuple] = None
        self._copies = _HostCopy()
        self._ema: Optional[float] = None
        self._ema_n = 0
        self._rollbacks = 0
        self._last_anomaly_gstep: Optional[int] = None
        self._last_restored: Optional[int] = None
        self.quarantined: set = set()
        self._low_precision = False
        self._lp_known = False
        #: Seconds of the last audit, on the host's clock.
        self.last_audit_s: Optional[float] = None

    def bind(self, strategy, *, checkpoint_dir=None,
             shard_keys: Optional[dict] = None) -> "IntegrityGuard":
        self._strategy = strategy
        if checkpoint_dir is not None:
            self.checkpoint_dir = os.fspath(checkpoint_dir)
        self._shard_keys = shard_keys
        return self

    # -- hot-loop surface ----------------------------------------------------

    def on_execution(self, first_gstep: int, k: int, health,
                     params: Optional[dict]) -> None:
        """Called once per execution, right after it is queued: start the
        new health vector's copy to the host, judge the previous one, run
        the SDC audit when its period is due (``params``: ``{keystr:
        tensor}``, :func:`named_leaves`)."""
        prev = self._pending
        self._pending = (first_gstep, k, *self._copies.start(health))
        if params is not None and not self._lp_known:
            self._lp_known = True
            self._low_precision = any(t.dtype in _LOW_PRECISION_DTYPES
                                      for t in params.values())
        if prev is not None:
            self._judge_pending(prev)
        n = self.cfg.audit_every_n
        if n and first_gstep and first_gstep % n == 0 and params is not None:
            self.audit(params, gstep=first_gstep)

    def flush(self) -> None:
        """Judge the in-flight health vector now: at the epoch boundary,
        before the callbacks run, so a poisoned final step never reaches
        ModelCheckpoint's epoch-end save."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._judge_pending(prev)

    def _judge_pending(self, pending) -> None:
        first_gstep, k, buf, event = pending
        self._judge(first_gstep, k, _HostCopy.read(buf, event))

    def should_skip(self, first_gstep: int, k: int) -> bool:
        """Quarantine: True when this window already caused a rollback
        and the config says replaying it would just re-poison."""
        if not self.cfg.quarantine or not self.quarantined:
            return False
        return any(first_gstep + i in self.quarantined for i in range(k))

    # -- rollback bookkeeping (trainer-facing) -------------------------------

    def rollback_plan(self, rb: RollbackAndReplay) -> Optional[int]:
        """The ``before=`` bound for ``latest_complete_step``: None for a
        first-time anomaly; the last restored step when replay hit this
        anomaly again without getting past it (restore strictly older)."""
        if (self._last_anomaly_gstep is not None
                and rb.gstep <= self._last_anomaly_gstep
                and self._last_restored is not None):
            return self._last_restored
        return None

    def note_rollback(self, rb: RollbackAndReplay,
                      restored: Optional[int]) -> None:
        self._last_anomaly_gstep = rb.gstep
        self._last_restored = restored
        self._pending = None  # pre-rollback health is stale

    # -- judgement -----------------------------------------------------------

    def _judge(self, first_gstep: int, k: int, health) -> None:
        h = np.asarray(health, dtype=np.float64).reshape(-1)
        nonfinite, gsq, usq = float(h[0]), float(h[1]), float(h[2])
        if (nonfinite > 0 or not math.isfinite(gsq)
                or not math.isfinite(usq)):
            self._anomaly("nan_loss", first_gstep, k, nonfinite=nonfinite)
        # Loss-scaled training reports S x larger raw grad norms; dividing
        # by the static scale judges (and logs) in true gradient units.
        gnorm = (math.sqrt(max(gsq, 0.0))
                 / max(float(self.cfg.loss_scale), 1e-30))
        factor = self.cfg.spike_factor
        if self._low_precision:
            factor *= max(float(self.cfg.bf16_spike_slack), 1.0)
        if (self._ema is not None and self._ema_n >= self.cfg.warmup_steps
                and gnorm > factor * max(self._ema, 1e-12)):
            self._anomaly("grad_spike", first_gstep, k,
                          grad_norm=round(gnorm, 6),
                          ema=round(self._ema, 6),
                          factor=round(factor, 6))
        d = self.cfg.ema_decay
        self._ema = gnorm if self._ema is None else d * self._ema + (1 - d) * gnorm
        self._ema_n += 1

    def _anomaly(self, kind: str, first_gstep: int, k: int,
                 **detail: Any) -> None:
        from tpu_dist_torch.observe import metrics as metrics_lib
        from tpu_dist_torch.resilience import events

        metrics_lib.inc("integrity.anomalies")
        events.maybe_log("integrity_anomaly", kind=kind, step=first_gstep,
                         window=k, attempt=events.current_attempt(), **detail)
        logger.warning("integrity anomaly %r at global step %d (+%d): %s",
                       kind, first_gstep, k, detail)
        self._rollbacks += 1
        if self.cfg.quarantine:
            self.quarantined.update(range(first_gstep, first_gstep + k))
        if self._rollbacks > self.cfg.rollback_budget:
            events.maybe_log("integrity_budget_exhausted", kind=kind,
                             step=first_gstep,
                             rollbacks=self._rollbacks - 1,
                             budget=self.cfg.rollback_budget)
            raise IntegrityAbort(
                f"rollback budget ({self.cfg.rollback_budget}) exhausted; "
                f"latest anomaly {kind!r} at step {first_gstep}")
        raise RollbackAndReplay(kind, first_gstep, **detail)

    # -- SDC audit -----------------------------------------------------------

    def audit(self, params: dict, *, gstep: int) -> bool:
        """One shard-group checksum compare over the processes; True when
        every group agrees, else an ``sdc`` anomaly naming each (rank,
        leaf) that deviates from its group's majority (every member of a
        group with no strict majority)."""
        t0 = time.perf_counter()
        paths = list(params)
        keys = self._shard_keys or {}
        local = np.stack([
            leaf_checksums(params.values()).cpu().numpy(),
            np.asarray([keys.get(p, 0) for p in paths], np.int64)])
        from tpu_dist_torch.parallel.collectives import host_all_gather

        table = np.asarray(host_all_gather(local)).reshape(-1, 2, len(paths))
        sums, groups_of = table[:, 0], table[:, 1]
        self.last_audit_s = time.perf_counter() - t0
        from tpu_dist_torch.observe import metrics as metrics_lib

        metrics_lib.observe_value("integrity.audit_s", self.last_audit_s)
        culprits = []
        for col, path in enumerate(paths):
            for gi, key in enumerate(np.unique(groups_of[:, col])):
                members = [int(r) for r in
                           np.flatnonzero(groups_of[:, col] == key)]
                vals = sums[members, col]
                if bool((vals == vals[0]).all()):
                    continue
                uniq, counts = np.unique(vals, return_counts=True)
                if int(counts.max()) * 2 > len(members):
                    majority = uniq[int(np.argmax(counts))]
                    bad = [m for m, v in zip(members, vals)
                           if v != majority]
                else:
                    bad = members
                culprits += [{"replica": m, "device": m, "rank": m,
                              "shard_group": gi, "leaf": path}
                             for m in bad]
        if not culprits:
            return True
        from tpu_dist_torch.resilience import events

        events.maybe_log("integrity_sdc", step=gstep, culprits=culprits,
                         attempt=events.current_attempt())
        logger.warning("SDC audit mismatch at step %d: %s", gstep, culprits)
        self._anomaly("sdc", gstep, 1, culprits=culprits)
        return False


def maybe_guard_from_env() -> Optional[IntegrityGuard]:
    """An :class:`IntegrityGuard` when ``$TPU_DIST_INTEGRITY=1``, else
    None: an unarmed fit pays one env read."""
    if os.environ.get(INTEGRITY_ENV) != "1":
        return None
    return IntegrityGuard(IntegrityConfig.from_env())
