"""MeshRuntime: the shared device pool and program cache jobs run on.

Counterpart of ``tpu_dist/jobs/runtime.py``. ``Trainer`` and
``ServeEngine`` stop owning their programs under a job and acquire them
through one runtime, so N jobs can share a pool without sharing anything
else. The runtime

* **owns the pool** — a sequence of slots, each a device (one card may
  fill several slots: the replicas or jobs of one process share it), the
  process's device by default, or a *virtual* pool of ``int`` slots for
  the subprocess-packed :class:`~tpu_dist_torch.jobs.scheduler.JobPool`,
  whose jobs are gangs of processes and which only does the arithmetic;
* **partitions it into slices** — a job's ``devices`` request is leased
  as one aligned, contiguous block, and a request that does not divide
  the pool is an error at submit time (the reshape-on-restore divisor
  rule);
* **owns the program cache** — under a job, the trainer's steps and
  captured programs and the engine's captured programs live in
  ``runtime.cached(key, builder)`` (:meth:`MeshRuntime.program_keys`
  lists them), keyed by the job, the model, the trainer or engine and the
  program's own key, so two jobs never run each other's closures.

**Solo no-op.** Outside a :func:`job_scope`, ``current_job()`` is None and
``Trainer`` / ``ServeEngine`` take exactly their earlier path: the same
strategy, the same instance-local programs, the same launches and
captures.

A :func:`job_scope` leases the slice, builds its strategy (one device a
process: a slice of one slot is ``MirroredStrategy`` on that device, more
than one is ROADMAP item 12b), pushes a :class:`JobContext` onto a
thread-local stack and enters the strategy's scope, so what the job builds
inside lands on its slot without a call site changing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

from tpu_dist_torch.jobs.spec import JobNamespace, JobSpec


class SubmeshLease:
    """One aligned, contiguous slice of the pool, held by one job."""

    def __init__(self, runtime: "MeshRuntime", start: int, size: int):
        self.runtime = runtime
        self.start = start
        self.size = size
        self.released = False

    @property
    def devices(self) -> Optional[tuple]:
        """The leased slots' devices, or None on a virtual pool."""
        if self.runtime.devices is None:
            return None
        return self.runtime.devices[self.start:self.start + self.size]

    def strategy(self):
        """The slice's strategy: ``MirroredStrategy`` over the leased
        devices (one device a process: a slice of several raises
        ``unported``, item 12b). A virtual pool's lease has no device: the
        job's own processes build their strategy."""
        if self.devices is None:
            raise RuntimeError(
                "virtual-pool leases carry no devices; the job's worker "
                "gang builds its own strategy, one device a process")
        from tpu_dist_torch.parallel.strategy import MirroredStrategy

        return MirroredStrategy(devices=list(self.devices))

    def release(self) -> None:
        self.runtime.release(self)

    def __repr__(self):
        return (f"SubmeshLease([{self.start}:{self.start + self.size}] "
                f"of {self.runtime.pool_size})")


class MeshRuntime:
    """The shared pool: slice leasing and the program cache.

    Args:
      devices: ``None`` = the process's device (the CUDA device; raises
        without one); a sequence = an explicit pool of slots, each a
        device or device name, repeats allowed; an ``int`` = a *virtual*
        pool of that many slots, with no devices (the JobPool's
        subprocess mode).
    """

    def __init__(self, devices: Union[None, int, Sequence] = None):
        if devices is None:
            from tpu_dist_torch.utils.device import resolve_device

            devices = (resolve_device(None),)
        if isinstance(devices, int):
            if devices < 1:
                raise ValueError(f"pool size must be >= 1, got {devices}")
            self.devices: Optional[tuple] = None
            self.pool_size = devices
        else:
            self.devices = tuple(torch.device(d) for d in devices)
            if not self.devices:
                raise ValueError("device pool must not be empty")
            self.pool_size = len(self.devices)
        self._lock = threading.Lock()
        self._held: dict[int, SubmeshLease] = {}   # start index -> lease
        self._programs: dict = {}
        self._program_hits = 0

    # -- partition arithmetic -------------------------------------------------

    def validate_request(self, n: int) -> int:
        """Divisor-validate a slice request: slices must tile the pool."""
        n = int(n)
        if n < 1:
            raise ValueError(f"job device request must be >= 1, got {n}")
        if n > self.pool_size:
            raise ValueError(
                f"job device request {n} exceeds the pool of "
                f"{self.pool_size} device(s)")
        if self.pool_size % n != 0:
            divisors = [d for d in range(1, self.pool_size + 1)
                        if self.pool_size % d == 0]
            raise ValueError(
                f"job device request {n} does not divide the pool of "
                f"{self.pool_size} device(s); submesh packing is a static "
                f"partition — request one of {divisors}")
        return n

    def free_devices(self) -> int:
        with self._lock:
            return self.pool_size - sum(l.size for l in self._held.values())

    def try_acquire(self, n: int) -> Optional[SubmeshLease]:
        """Lease the first free aligned block of ``n`` slots, or None when
        every fitting slice is held (the scheduler then queues)."""
        n = self.validate_request(n)
        with self._lock:
            for start in range(0, self.pool_size, n):
                if all(not (h <= start < h + lease.size)
                       and not (start <= h < start + n)
                       for h, lease in self._held.items()):
                    lease = SubmeshLease(self, start, n)
                    self._held[start] = lease
                    return lease
        return None

    def acquire(self, n: int) -> SubmeshLease:
        lease = self.try_acquire(n)
        if lease is None:
            raise RuntimeError(
                f"no free submesh slice of {n} device(s) in a pool of "
                f"{self.pool_size} ({self.free_devices()} free, "
                f"fragmented across held slices)")
        return lease

    def release(self, lease: SubmeshLease) -> None:
        with self._lock:
            if lease.released or self._held.get(lease.start) is not lease:
                raise RuntimeError(f"double release of {lease!r}")
            del self._held[lease.start]
            lease.released = True

    # -- the program cache ------------------------------------------------------

    def cached(self, key, builder):
        """The program under ``key``, built by ``builder()`` (and kept) on
        first use. Keys carry the owner's identity: the runtime shares
        storage, never closures."""
        with self._lock:
            if key in self._programs:
                self._program_hits += 1
                return self._programs[key]
        program = builder()   # outside the lock: building may re-enter
        with self._lock:
            return self._programs.setdefault(key, program)

    def program_keys(self) -> list:
        with self._lock:
            return sorted(self._programs, key=repr)

    @property
    def program_hits(self) -> int:
        return self._program_hits


class JobContext:
    """What a job's in-process run sees: its spec, namespace, lease,
    strategy, and the runtime whose cache holds its programs."""

    def __init__(self, *, spec: JobSpec, namespace: JobNamespace,
                 runtime: MeshRuntime, lease: SubmeshLease, strategy):
        self.spec = spec
        self.namespace = namespace
        self.runtime = runtime
        self.lease = lease
        self.strategy = strategy

    def program_key(self, *parts) -> tuple:
        """A cache key scoped to this job and its owner's identity."""
        return (self.spec.name, *parts)


_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def current_job() -> Optional[JobContext]:
    """The innermost active job on this thread, or None: the solo path
    every Trainer and ServeEngine constructor checks."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def job_scope(runtime: MeshRuntime, spec: JobSpec, *,
              root: Optional[str] = None):
    """Place ``spec`` on ``runtime``: lease its slice, enter its strategy's
    scope, and expose the :class:`JobContext` to everything built inside.
    The lease is released on exit, on completion or failure."""
    lease = runtime.acquire(spec.devices)
    try:
        strategy = lease.strategy()
        ctx = JobContext(spec=spec, namespace=JobNamespace(spec, root),
                         runtime=runtime, lease=lease, strategy=strategy)
        _stack().append(ctx)
        try:
            with strategy.scope():
                yield ctx
        finally:
            popped = _stack().pop()
            assert popped is ctx, "job_scope stack corrupted"
    finally:
        if not lease.released:
            lease.release()
