"""Continuous-batching request scheduler: slot assignment between steps.

The engine's programs are keyed by *bucket* (padded batch size), so all
the scheduler has to do — and all it does — is keep the set of active
cache slots a compact prefix and decide, between decode steps, which
queued requests enter and which active ones leave:

* **FIFO admission** into the lowest free slot. ``continuous`` policy
  admits whenever a slot is free (requests join mid-flight next step);
  ``static`` policy only admits into an EMPTY batch and runs that cohort
  to completion AT THE COHORT'S BUCKET — a request finishing early stops
  consuming tokens but its padded slot keeps paying decode compute until
  the whole cohort drains, which is exactly the head-of-line blocking
  the serve benchmark measures continuous batching against.
* **Completion/eviction between steps**: a request leaves when it emits
  EOS, reaches its ``max_new_tokens``, or blows its deadline. Freed
  slots are compacted by swapping the last active slot down (the engine
  mirrors each swap in the KV cache via ``kv_cache.swap_slots``), so the
  active count maps to the smallest padded bucket.
* **No starvation**: admission is strictly arrival-ordered and every
  active request makes one token of progress per decode step (there is
  no preemption and no reordering), so under a full batch a queued
  request waits only for the bounded completion of earlier requests.

Host-side and framework-free on purpose: scheduling decisions happen
between device steps, never inside them. This is the port's own copy of
the contiguous-engine subset of ``tpu_dist/serve/scheduler.py`` (the port
imports nothing of ``tpu_dist``); the two must stay behaviourally
identical, which ``tests/test_torch_serve.py`` checks. The reference's
bounded queue, journal request ids, admission gate and chunked-prefill
queue come with the port's shedding, journal, paging and chunking.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

#: Request lifecycle states. SHED is terminal like DONE/EVICTED but
#: mutually exclusive with both: a shed request was rejected at admission
#: and never occupied a slot (the port's engine does not shed yet).
QUEUED, ACTIVE, DONE, EVICTED, SHED = ("queued", "active", "done",
                                       "evicted", "shed")


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    prompt: list  #: int token ids, len >= 1
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None  #: wall seconds from submit
    rid: int = -1
    status: str = QUEUED
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    submit_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    finish_reason: Optional[str] = None  #: eos | length | deadline

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.submit_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always including it): one
    decode program per bucket, log2(cap) programs total."""
    bs = [b for b in itertools.takewhile(lambda b: b < max_batch,
                                         (1 << i for i in range(31)))]
    return tuple(bs) + (max_batch,)


class Scheduler:
    """Slot-based continuous (or static) batching over ``max_batch`` KV
    slots. The engine drives it: ``admit()`` before each decode step,
    ``finish()``/``evict_deadline()`` after, ``bucket()`` to pick the
    decode program."""

    def __init__(self, max_batch: int, *, policy: str = "continuous"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        self.max_batch = max_batch
        self.policy = policy
        self.buckets = default_buckets(max_batch)
        self.queue: list[Request] = []  #: FIFO, arrival order
        #: active requests by slot; slots [0, num_active) are occupied.
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.num_active = 0
        self._cohort = 0  #: static policy: admitted cohort size, sticky
        self._next_rid = 0

    # -- intake ---------------------------------------------------------------

    def submit(self, req: Request, *, now: float) -> Request:
        """Queue a request under the next sequential id."""
        if not req.prompt:
            raise ValueError("empty prompt")
        req.rid = self._next_rid
        self._next_rid += 1
        req.submit_s = now
        req.status = QUEUED
        self.queue.append(req)
        return req

    # -- admission ------------------------------------------------------------

    def admit(self) -> list[Request]:
        """Move queued requests into free slots (FIFO); returns the newly
        admitted requests, each with ``slot`` assigned — the engine owes
        each one a prefill before the next decode step."""
        if self.policy == "static" and self.num_active > 0:
            return []  # static cohorts run to completion before refilling
        admitted = []
        while self.queue and self.num_active < self.max_batch:
            req = self.queue.pop(0)
            req.slot = self.num_active
            req.status = ACTIVE
            self.slots[req.slot] = req
            self.num_active += 1
            admitted.append(req)
        if self.policy == "static" and admitted:
            self._cohort = self.num_active
        return admitted

    # -- step accounting ------------------------------------------------------

    def active(self) -> list[Request]:
        """Active requests in slot order: every one takes part in the next
        decode step."""
        return [r for r in self.slots[:self.num_active]]

    def bucket(self) -> int:
        """Smallest bucket holding every active slot — or, under the static
        policy, the whole admitted cohort: drained slots keep paying
        padded-batch compute until the cohort completes (the cost
        continuous batching exists to reclaim)."""
        n = max(self.num_active, 1)
        if self.policy == "static":
            n = max(n, self._cohort)
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch  # unreachable: buckets[-1] == max_batch

    def record_token(self, req: Request, token: int, *, now: float) -> bool:
        """Append a generated token; returns True when the request is now
        complete (EOS or length). The caller still owns the slot until it
        calls :meth:`finish`."""
        if req.first_token_s is None:
            req.first_token_s = now
        req.generated.append(int(token))
        if req.eos_id is not None and int(token) == req.eos_id:
            req.finish_reason = "eos"
            return True
        if len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    # -- release + compaction -------------------------------------------------

    def finish(self, req: Request, *, now: float,
               status: str = DONE) -> Optional[tuple[int, int]]:
        """Release a request's slot. Returns ``(freed, last)`` when the
        engine must mirror a cache-row swap (last active slot moved down
        into the freed slot), or None when the freed slot was already
        last. Call with descending slot numbers when releasing several at
        once, so earlier swaps don't invalidate later slot indices."""
        slot = req.slot
        if not (0 <= slot < self.num_active and self.slots[slot] is req):
            raise ValueError(f"request {req.rid} does not own slot {slot}")
        req.status = status
        req.finish_s = now
        req.slot = -1
        last = self.num_active - 1
        swap = None
        if slot != last:
            mover = self.slots[last]
            mover.slot = slot
            self.slots[slot] = mover
            swap = (slot, last)
        self.slots[last] = None
        self.num_active -= 1
        if self.num_active == 0:
            self._cohort = 0
        return swap

    def evict_deadline(self, *, now: float) -> list[tuple[Request,
                                                          Optional[tuple]]]:
        """Evict active requests past their deadline. Returns
        ``[(request, swap_or_None), ...]``; swaps are produced
        high-slot-first so the engine can apply them in order."""
        out = []
        stale = sorted(
            (r for r in self.slots[:self.num_active]
             if r.deadline_s is not None
             and now - r.submit_s > r.deadline_s),
            key=lambda r: r.slot, reverse=True)
        for req in stale:
            req.finish_reason = "deadline"
            out.append((req, self.finish(req, now=now, status=EVICTED)))
        # Expire queued requests too — they can't meet a blown deadline.
        still = []
        for req in self.queue:
            if (req.deadline_s is not None
                    and now - req.submit_s > req.deadline_s):
                req.status = EVICTED
                req.finish_s = now
                req.finish_reason = "deadline"
                out.append((req, None))
            else:
                still.append(req)
        self.queue = still
        return out

    # -- introspection --------------------------------------------------------

    def queue_depth(self) -> int:
        return len(self.queue)

    def idle(self) -> bool:
        return self.num_active == 0 and not self.queue
