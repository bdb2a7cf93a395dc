"""ServeEngine: the continuous-batching inference loop on one device.

Counterpart of ``tpu_dist/serve/engine.py``. Scheduling stays
host-side in ``scheduler.py`` (and ``paging.py`` for the paged pool), math
in ``kv_cache.py``; the engine owns the model on its device, the KV cache
or page pool and the host mirrors of per-slot decode state:

* prompts pad up to a power of two (at least 8, at most ``max_len``) and
  each admitted request pays one prefill, which emits its first token;
  with ``prefill_chunk > 0`` the prefill runs in chunks interleaved with
  decode steps instead;
* each :meth:`step` runs one decode step over the scheduler's bucket (the
  smallest configured bucket covering the active slots; powers of two by
  default), or, with ``ragged=True``, over every slot under an active mask;
* a freed slot is compacted by swapping the last active slot down, and
  the engine mirrors the swap in the cache (``kv_cache.swap_slots``) or,
  paged, in the host page tables.

``paged=True`` serves from a page pool: admission reserves each request's
worst-case pages, repeated prompt prefixes attach shared read-only pages
(prefill runs over the suffix only), a write into a shared page copies it
first, and ``kv_dtype="int8"`` stores quantized pages. The host's page
table is sent to the device with every call that reads it.

Where the reference ``jax.jit``s one program per family and key (a
decode bucket, a prefill pad), the port on CUDA runs each family and key
through one :class:`~tpu_dist_torch.utils.graphs.CapturedProgram`: the
first call runs eagerly, the second captures a CUDA graph, every later one
replays it from static input buffers that pinned staging fills. The host
mirrors and page tables cross to the card by that staging; on the CPU the
functions run eagerly on copies of them. Under a job scope
(``jobs/runtime.py``) the engine serves on the job's slot unless given a
device, and its captured programs live in the job's ``MeshRuntime`` cache
(:meth:`ServeEngine._acquire_program`); outside one nothing changes.
:meth:`compiled_programs` reports
the keys used, the reference's program families, and
:attr:`ServeEngine.capture_seconds` the time spent capturing, which is
no request's. Every step emits host-side metrics (``observe/metrics.py``)
under the reference's names.

Resilience, as in the reference (``serve/journal.py``): an optional
durable request journal makes a supervised restart replay queued and
in-flight requests with token-identical greedy continuations; a bounded
admission queue and projected-TTFT/deadline feasibility checks shed load
the engine cannot serve (``finish_reason="shed"``); a decode-stall
watchdog turns a hung decode step — its dispatch and the host read of its
logits, which waits for the device — into a classified fault
(:data:`~tpu_dist_torch.resilience.faults.EXIT_SERVE_ABORT`) instead of
blocking the serving loop forever.
"""

from __future__ import annotations

import collections
import functools
import itertools
import logging
import os
import sys
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import EXIT_SERVE_ABORT
from tpu_dist_torch.serve import journal as journal_lib
from tpu_dist_torch.serve import kv_cache, paging
from tpu_dist_torch.serve.scheduler import DONE, SHED, Request, Scheduler
from tpu_dist_torch.utils import graphs
from tpu_dist_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _current_job():
    """The active job scope, read through ``sys.modules`` so a solo engine
    never imports the jobs runtime (its solo no-op)."""
    mod = sys.modules.get("tpu_dist_torch.jobs.runtime")
    return mod.current_job() if mod is not None else None


#: Engine serials: the cache-key part that keeps two engines of one model
#: from sharing job-cached programs.
_ENGINE_SERIALS = itertools.count()

_MIN_PROMPT_PAD = 8

#: ``kv_dtype`` names and the pool dtypes they select.
_KV_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}

#: EMA smoothing for the decode-step wall-time estimate behind the
#: projected-TTFT admission check.
_EMA_ALPHA = 0.3


def _default_stall_action(info: dict) -> None:
    """What a production engine does about a hung decode step: classify it
    as a fault and die with the registered serve exit code — the
    ServeSupervisor restarts the engine and the journal replays the work.
    ``os._exit`` on purpose: the main thread is wedged inside the device
    call, so no Python-level unwind can run."""
    logger.error("serve: decode step stalled > %.3fs (bucket %s) — "
                 "exiting %d (serve_abort) for supervised restart",
                 info.get("timeout_s", -1.0), info.get("bucket"),
                 EXIT_SERVE_ABORT)
    events.maybe_log("serve_stall", **info)
    os._exit(EXIT_SERVE_ABORT)


def _pad_to_pow2(n: int, *, lo: int = _MIN_PROMPT_PAD, hi: int) -> int:
    p = lo
    while p < n:
        p <<= 1
    return min(p, hi)


class ServeEngine:
    """Continuous-batching decode loop over a fixed pool of KV slots.

    Args:
      model: a ``Sequential`` from the servable family (see
        ``kv_cache.build_plan``), served with its own weights (initialized
        from a seed when built, or loaded with ``load_jax_params``). The
        engine moves it to ``device``.
      max_batch: KV slots == maximum concurrent requests.
      max_len: per-slot cache capacity (prompt + generated tokens);
        defaults to the model's positional-table length.
      buckets / policy: forwarded to :class:`Scheduler` (``buckets``:
        the decode batch sizes, powers of two up to ``max_batch`` by
        default; the largest must be ``max_batch``).
      temperature: 0 = greedy argmax; > 0 samples from the tempered softmax
        with a host-side generator seeded by ``seed``.
      cache_dtype: KV cache dtype.
      clock: a monotonic clock in seconds (``time.monotonic`` by
        default); tests inject one to pin deadlines and latencies.
      journal: a :class:`~tpu_dist_torch.serve.journal.RequestJournal`, or
        a directory to open one in (its rotation threshold from
        ``$TPU_DIST_SERVE_JOURNAL_MAX_BYTES``). When the directory already
        holds a journal — either package's — the engine RECOVERS before
        serving: unfinished requests are re-admitted under their journaled
        ids in arrival order, the formerly active ones re-prefilled with
        ``prompt + tokens_emitted_so_far``.
      max_queue: bounded admission queue — submissions past this depth are
        shed (``finish_reason="shed"``, cause ``queue_full``).
      max_ttft_s: shed a submission whose projected time-to-first-token
        (the tokens owed ahead of it over ``max_batch`` lanes, at the EMA
        decode-step time) exceeds this bound (cause ``projected_ttft``).
      retry_budget: a journal-replayed request found ACTIVE in more than
        this many crashes is shed instead of re-admitted (cause
        ``retry_budget``) — poison-pill protection.
      stall_timeout_s: decode-stall watchdog — a decode step (dispatch
        through the host read of its logits) exceeding this wall bound
        calls ``stall_action`` (default: exit ``EXIT_SERVE_ABORT`` for a
        supervised restart). None disables the watchdog. On CUDA a
        program's first two calls (eager, then the capture) sit inside
        the window too: size the bound above them.
      stall_action: the watchdog's action (tests record instead of
        exiting); receives an info dict.
      fault_injector: serve chaos seam — an object with ``on_decode`` /
        ``on_step_end`` hooks (:class:`~tpu_dist_torch.resilience.
        injector.ServeFaultInjector`).
      virtual_step_s: when > 0 and ``clock`` has an ``advance`` method, the
        engine advances the clock by this much per decode step — a
        deterministic stand-in for a model's step time (the request-storm
        gate measures queueing delay in these virtual seconds).
      paged: serve from the paged KV pool (``serve/paging.py``): memory
        is carved into fixed-size pages addressed through per-slot page
        tables, admission consults free-page headroom as well as slots,
        repeated prompt prefixes resolve to shared read-only pages, and
        slot compaction is a host pointer swap. Greedy streams equal the
        contiguous engine's.
      page_size: positions per page (paged mode).
      num_pages: pool size (paged mode). Defaults to
        ``max_batch * ceil(max_len / page_size)``; pass fewer (or a
        ``budget_bytes``) to overcommit slots against actual lengths.
      budget_bytes: hard KV-memory bound. Contiguous mode: raise a loud
        sizing error (how many slots fit). Paged mode: sizes
        ``num_pages`` to the budget when ``num_pages`` is not given, else
        guards the explicit pool the same way.
      prefix_caching: paged mode only — disable to keep paging without
        cross-request prefix sharing.
      prefill_chunk: when > 0, split each admitted prompt's prefill into
        chunks of this many positions (a power of two >= 8) interleaved
        with decode steps. Each chunk attends over all earlier cached
        positions, so greedy streams equal whole-prompt prefill's. A slot
        being chunk-prefilled stays out of decode until its final chunk,
        which emits the first token. Contiguous mode needs it to divide
        ``max_len``. Default 0: whole-prompt prefill.
      prefill_interleave: most prefill chunks run between two decode
        steps (default 1); chunks drain in arrival order.
      kv_dtype: paged-pool storage dtype — ``"fp32"``/``"bf16"``/
        ``"int8"`` (or the torch dtypes). ``"int8"`` stores K/V pages as
        int8 with per-position fp32 scale rows, about twice the pages at
        a fixed ``budget_bytes``. Paged mode only; default None: the pool
        dtype is ``cache_dtype``.
      ragged: paged mode only — decode ALL slots in one full-capacity
        program with a per-slot active mask instead of the bucketed
        family (``kv_cache.paged_decode_ragged``): one decode program (on
        CUDA one graph), and streams token-identical to the bucketed
        engine's. Default False.
      device: ``None`` (the CUDA device; raises without one) or an explicit
        device such as ``"cpu"``. On CUDA every program family runs as
        captured CUDA graphs (module docstring).
    """

    def __init__(self, model: Sequential, *, max_batch: int = 8,
                 max_len: Optional[int] = None,
                 buckets: Optional[tuple[int, ...]] = None,
                 policy: str = "continuous", temperature: float = 0.0,
                 seed: int = 0, cache_dtype=torch.float32, clock=None,
                 journal=None, max_queue: Optional[int] = None,
                 max_ttft_s: Optional[float] = None, retry_budget: int = 3,
                 stall_timeout_s: Optional[float] = None,
                 stall_action=None, fault_injector=None,
                 virtual_step_s: float = 0.0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 budget_bytes: Optional[int] = None,
                 prefix_caching: bool = True, prefill_chunk: int = 0,
                 prefill_interleave: int = 1, kv_dtype=None,
                 ragged: bool = False, device=None):
        self._job = _current_job()
        self._serial = next(_ENGINE_SERIALS)
        if device is None and self._job is not None:
            device = self._job.strategy.device
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.plan = kv_cache.build_plan(model)
        self.max_len = int(max_len or self.plan.max_position)
        if self.max_len > self.plan.max_position:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's positional "
                f"table ({self.plan.max_position})")
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_interleave = int(prefill_interleave)
        if self.prefill_chunk:
            if (self.prefill_chunk < _MIN_PROMPT_PAD
                    or self.prefill_chunk & (self.prefill_chunk - 1)):
                raise ValueError(
                    f"prefill_chunk must be a power of two >= "
                    f"{_MIN_PROMPT_PAD}, got {prefill_chunk}")
            if not paged and self.max_len % self.prefill_chunk:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} must divide "
                    f"max_len {self.max_len} on the contiguous path — "
                    "chunk K/V writes are dynamic_update_slice windows "
                    "that must never run past the cache row")
        if self.prefill_interleave < 1:
            raise ValueError(
                f"prefill_interleave must be >= 1, got {prefill_interleave}")
        self.max_batch = int(max_batch)
        self.temperature = float(temperature)
        self.clock = clock or time.monotonic
        self._rng = np.random.default_rng(seed)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.ragged = bool(ragged)
        if self.ragged and not self.paged:
            raise ValueError(
                "serve: ragged decode rides the page tables (one full-"
                "capacity program, per-slot masking) — pass paged=True")
        if kv_dtype is not None:
            if not self.paged:
                raise ValueError(
                    "serve: kv_dtype is a paged-pool knob — pass "
                    "paged=True (the contiguous cache keeps cache_dtype)")
            cache_dtype = _KV_DTYPES.get(kv_dtype, kv_dtype)
            if cache_dtype not in _KV_DTYPES.values():
                raise ValueError(
                    f"serve: kv_dtype must be one of fp32/bf16/int8, "
                    f"got {kv_dtype!r}")
        self._kv_quant = self.paged and cache_dtype == torch.int8
        if self.paged:
            max_pages = -(-self.max_len // self.page_size)
            if num_pages is None and budget_bytes is not None:
                num_pages = kv_cache.pages_for_budget(
                    self.plan, page_size=self.page_size,
                    budget_bytes=budget_bytes, dtype=cache_dtype)
                if num_pages < 1:
                    raise ValueError(
                        f"serve: budget_bytes={budget_bytes} does not fit "
                        "even one page (plus scratch) at page_size="
                        f"{self.page_size}")
            if num_pages is None:
                num_pages = self.max_batch * max_pages
            self.num_pages = int(num_pages)
            self.cache = kv_cache.init_page_pool(
                self.plan, num_pages=self.num_pages,
                page_size=self.page_size, dtype=cache_dtype,
                budget_bytes=budget_bytes, device=self.device)
            # Per-position pool bytes, derived from the page layout so
            # int8's fp32 scale rows are priced in.
            per_token = kv_cache.page_nbytes(
                self.plan, page_size=self.page_size,
                dtype=cache_dtype) // self.page_size
            self._paging = paging.PagedKVState(
                num_pages=self.num_pages, page_size=self.page_size,
                slots=self.max_batch, max_pages=max_pages,
                bytes_per_token=per_token, prefix_caching=prefix_caching)
            logger.info(
                "serve: paged — %d slots, %d pages x %d positions "
                "(+scratch) on %s, pool %.1f MiB (%s), prefix caching %s, "
                "decode %s", self.max_batch, self.num_pages,
                self.page_size, self.device,
                kv_cache.page_pool_nbytes(
                    self.plan, num_pages=self.num_pages,
                    page_size=self.page_size, dtype=cache_dtype) / 2**20,
                cache_dtype, "on" if prefix_caching else "off",
                "ragged" if self.ragged else
                f"buckets {buckets or 'pow2'}")
        else:
            self._paging = None
            self.cache = kv_cache.init_cache(
                self.plan, max_batch=self.max_batch, max_len=self.max_len,
                dtype=cache_dtype, budget_bytes=budget_bytes,
                device=self.device)
            logger.info(
                "serve: %d slots x %d positions on %s, KV cache %.1f MiB, "
                "buckets %s", self.max_batch, self.max_len, self.device,
                kv_cache.cache_nbytes(self.plan, max_batch=self.max_batch,
                                      max_len=self.max_len,
                                      dtype=cache_dtype) / 2**20,
                buckets or "pow2")
        self.scheduler = Scheduler(self.max_batch, buckets=buckets,
                                   policy=policy, max_queue=max_queue)
        # Host mirrors of per-slot decode state (compacted with the
        # scheduler's slot moves).
        self._tokens = np.zeros(self.max_batch, np.int64)
        self._lengths = np.zeros(self.max_batch, np.int64)
        self.finished: list[Request] = []
        #: ``family -> keys`` run so far, on either device.
        self._keys: dict[str, set[int]] = collections.defaultdict(set)
        #: ``(family, key) -> CapturedProgram`` on CUDA (empty on the CPU).
        self.programs: dict[tuple[str, int], graphs.CapturedProgram] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        #: Seconds spent capturing graphs, apart from any request's time.
        self.capture_seconds = 0.0

        # -- resilience state --------------------------------------------
        self.max_ttft_s = None if max_ttft_s is None else float(max_ttft_s)
        self.retry_budget = int(retry_budget)
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        self.stall_action = stall_action or _default_stall_action
        self.fault_injector = fault_injector
        self.virtual_step_s = float(virtual_step_s)
        self._step_ema_s: Optional[float] = None
        self._done_count = 0
        self._closed = False
        #: What the last journal recovery did (None: nothing recovered).
        self.last_replay: Optional[dict] = None
        #: Request ids the journal knew at start-up (resubmission skips
        #: them: the replay owns those requests).
        self.known_rids: set = set()
        if journal is None:
            self.journal: Optional[journal_lib.RequestJournal] = None
        elif isinstance(journal, journal_lib.RequestJournal):
            self.journal = journal
        else:
            self.journal = journal_lib.RequestJournal(
                journal, max_bytes=journal_lib.journal_max_bytes_from_env())
        if self.journal is not None:
            self._recover_from_journal()
        metrics.set_gauge("serve.ready", 1.0)

    # -- crash recovery -------------------------------------------------------

    def _recover_from_journal(self) -> None:
        """Replay an existing journal into the scheduler: formerly active
        requests first (arrival order, re-prefilled with their journaled
        tokens), then the queued ones; requests whose journaled tokens
        already satisfy their stop condition finish here; actives past the
        retry budget are shed."""
        t0 = time.monotonic()
        state = journal_lib.load(self.journal.path)
        self.known_rids = state.known_rids
        # Seed id allocation from the whole id space, rotated-away ids
        # included: a fresh submit must never reuse one.
        self.scheduler._next_rid = max(self.scheduler._next_rid,
                                       state.next_rid)
        if not state.requests:
            return
        active, queued = state.pending()
        completed, replayed, shed = [], [], []
        for jr in active + queued:
            req = Request(prompt=list(jr.prompt),
                          max_new_tokens=jr.max_new_tokens,
                          eos_id=jr.eos_id, deadline_s=jr.deadline_s,
                          generated=list(jr.tokens), replays=jr.replays)
            if jr.stop_satisfied():
                # The work survived the crash; only its terminal record
                # was lost. Finish it now, never re-admit.
                req.rid = jr.rid
                req.status = DONE
                req.finish_reason = jr.implied_finish_reason()
                self.finished.append(req)
                self.journal.record_finish(req)
                self._done_count += 1
                metrics.inc("serve.requests.completed")
                completed.append(jr.rid)
                continue
            if jr.tokens and jr.replays + 1 > self.retry_budget:
                req.rid = jr.rid
                self._shed(req, "retry_budget", journaled=True)
                shed.append(jr.rid)
                continue
            # Deadlines re-arm relative to re-submission: the original
            # submit time is from a dead process.
            self.scheduler.submit(req, now=self.clock(), rid=jr.rid)
            replayed.append(jr.rid)
        replay_s = time.monotonic() - t0
        attempt = len(state.replay_markers) + 1
        self.last_replay = {
            "attempt": attempt,
            "active": [r.rid for r in active],
            "queued": [r.rid for r in queued],
            "replayed": replayed, "completed": completed, "shed": shed,
            "replay_s": replay_s,
        }
        self.journal.record_replay(
            attempt=attempt, queued=[r.rid for r in queued],
            active=[r.rid for r in active], completed=completed,
            replay_s=replay_s)
        metrics.observe_value("serve.journal.replay_s", replay_s)
        events.maybe_log("serve_replay", attempt=attempt,
                         replayed=len(replayed), completed=len(completed),
                         shed=len(shed), replay_s=round(replay_s, 6))
        logger.info(
            "serve: journal replay #%d — %d re-admitted (%d were active), "
            "%d finished from journaled tokens, %d shed, %.3fs",
            attempt, len(replayed), len(active), len(completed),
            len(shed), replay_s)

    @classmethod
    def from_saved(cls, directory, **kwargs) -> "ServeEngine":
        """Load a ``save_model`` directory, written by either package
        (weights restored, no training compile), onto the engine's device
        (``device=``, as the constructor takes it) and serve it."""
        from tpu_dist_torch.models import serialize

        model = serialize.load_model(directory, compile=False,
                                     device=kwargs.get("device"))
        return cls(model, **kwargs)

    def compiled_programs(self) -> dict:
        """``{'decode': [buckets...], 'prefill': [pad_lens...]}`` used so
        far — the reference's program families; on CUDA each key is one
        :attr:`programs` entry, captured at its second use. Paged engines
        add ``paged_decode``/``paged_prefill`` (a suffix after a prefix
        hit pads to its own power of two; paged chunks run through
        ``paged_prefill`` too; a ragged engine's one decode key is
        ``max_batch``); contiguous chunked engines add
        ``prefill_chunk``."""
        families = ["decode", "prefill"]
        if self.paged:
            families += ["paged_decode", "paged_prefill"]
        if self.prefill_chunk and not self.paged:
            families.append("prefill_chunk")
        return {f: sorted(self._keys[f]) for f in families}

    # -- request intake -------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens does not fit a "
                f"{self.max_len}-position cache slot (need >= 1 free)")
        if self.paged:
            # Reject a request that could never fit even an empty pool
            # now, loudly, instead of deadlocking admission later.
            self._paging.check_fits(
                min(len(prompt) + int(max_new_tokens), self.max_len))
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, deadline_s=deadline_s)
        cause = self._shed_cause(req)
        if cause is not None:
            return self._shed(req, cause)
        self.scheduler.submit(req, now=self.clock())
        metrics.inc("serve.requests.submitted")
        if self.journal is not None:
            self.journal.record_submit(req)
        return req

    def adopt_request(self, prompt: Sequence[int], *,
                      generated: Sequence[int] = (),
                      max_new_tokens: int = 32,
                      eos_id: Optional[int] = None,
                      deadline_s: Optional[float] = None,
                      replays: int = 0) -> Request:
        """Adopt another engine's in-flight request (fleet failover).

        The caller hands over the prompt plus every token the other engine
        already emitted. The request gets a FRESH id from this engine's
        :meth:`Scheduler.reserve_rid` (two engines' id spaces overlap), its
        submit and token trail is re-journaled so a later crash here
        replays it like native work, and the greedy continuation
        re-prefills ``prompt + generated``. As in journal recovery, tokens
        that already meet the stop condition finish here without a slot,
        and a request seen ACTIVE in more than ``retry_budget`` crashes is
        shed (cause ``retry_budget``)."""
        prompt = [int(t) for t in prompt]
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens does not fit a "
                f"{self.max_len}-position cache slot (need >= 1 free)")
        if self.paged:
            self._paging.check_fits(
                min(len(prompt) + int(max_new_tokens), self.max_len))
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, deadline_s=deadline_s,
                      generated=[int(t) for t in generated],
                      replays=int(replays))
        req.rid = self.scheduler.reserve_rid()
        if self.journal is not None:
            self.journal.record_submit(req)
            for t in req.generated:
                self.journal.record_token(req.rid, t)
        hit_eos = req.eos_id is not None and req.eos_id in req.generated
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            now = self.clock()
            req.status = DONE
            req.finish_reason = "eos" if hit_eos else "length"
            req.submit_s = now
            req.finish_s = now
            self.finished.append(req)
            if self.journal is not None:
                self.journal.record_finish(req)
            self._done_count += 1
            metrics.inc("serve.requests.completed")
            return req
        if req.generated and req.replays + 1 > self.retry_budget:
            return self._shed(req, "retry_budget", journaled=True)
        self.scheduler.submit(req, now=self.clock(), rid=req.rid)
        metrics.inc("serve.requests.adopted")
        return req

    # -- overload protection --------------------------------------------------

    def _projected_ttft_s(self) -> float:
        """Conservative time-to-first-token estimate for a request joining
        the queue now: every token owed by work ahead of it (active
        remainders and whole queued requests), spread over ``max_batch``
        lanes, at the EMA decode-step time. 0.0 until the first decode step
        has been measured."""
        if self._step_ema_s is None:
            return 0.0
        owed = sum(max(r.max_new_tokens - len(r.generated), 0)
                   for r in self.scheduler.active())
        owed += sum(r.max_new_tokens for r in self.scheduler.queue)
        return (owed / self.max_batch) * self._step_ema_s

    def _shed_cause(self, req: Request) -> Optional[str]:
        """Admission control, cheapest check first: queue bound, then
        deadline feasibility (could this request meet its deadline even if
        admitted now?), then projected TTFT."""
        if self.scheduler.full():
            return "queue_full"
        projected = self._projected_ttft_s()
        if req.deadline_s is not None and self._step_ema_s is not None:
            need = projected + req.max_new_tokens * self._step_ema_s
            if need > req.deadline_s:
                return "deadline_unmeetable"
        if self.max_ttft_s is not None and projected > self.max_ttft_s:
            return "projected_ttft"
        return None

    def _shed(self, req: Request, cause: str, *,
              journaled: bool = False) -> Request:
        """Reject ``req`` at admission: terminal SHED state, never a slot.
        Journaled (submit and finish) so a post-crash replay does not
        resurrect it — shed is an answer, not a loss."""
        if req.rid < 0:
            req.rid = self.scheduler.reserve_rid()
        req.status = SHED
        req.finish_reason = "shed"
        req.shed_cause = cause
        now = self.clock()
        req.submit_s = req.submit_s or now
        req.finish_s = now
        self.finished.append(req)
        metrics.inc("serve.requests.shed")
        if self.journal is not None:
            if not journaled:
                self.journal.record_submit(req)
            self.journal.record_finish(req)
        logger.info("serve: shed request %d (%s)", req.rid, cause)
        return req

    # -- sampling (host-side) -------------------------------------------------

    def _pick(self, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        return int(self._rng.choice(logits.shape[-1], p=p / p.sum()))

    # -- host -> device -------------------------------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        mirrors and page tables change after the call). The CPU path's: a
        pageable copy cannot be captured."""
        return torch.tensor(array, device=self.device)

    def _run(self, family: str, key: int, fn, **inputs):
        """``fn(**inputs)`` as the program of ``family`` at ``key``. On the
        CPU, eagerly on device copies of the host arrays (ints as they
        are). On CUDA through that key's captured program, fed from
        ``inputs`` by its pinned staging; the outputs are read before the
        next call."""
        self._keys[family].add(key)
        if self.device.type != "cuda":
            return fn(**{n: self._to_device(v) if isinstance(v, np.ndarray)
                         else v for n, v in inputs.items()})
        prog = self.programs.get((family, key))
        if prog is None:
            prog = self.programs[(family, key)] = self._acquire_program(
                family, key, lambda: graphs.CapturedProgram(
                    fn, {n: graphs.spec_of(v) for n, v in inputs.items()},
                    device=self.device, pool=self._graph_pool))
        captured = prog.graph is not None
        out = prog(**inputs)
        if not captured and prog.graph is not None:
            self.capture_seconds += prog.capture_s
        return out

    def _acquire_program(self, family: str, key, builder):
        """``builder()``'s program: made here outside a job scope; under
        one, taken from the job's ``MeshRuntime`` cache under a key of the
        job, the model, this engine and ``(family, key)``."""
        if self._job is None:
            return builder()
        return self._job.runtime.cached(
            self._job.program_key(self.model.name, self._serial, family,
                                  key), builder)

    def _copy_pages(self, copies) -> None:
        """Run the copy-on-write ``(src, dst)`` page copies in order."""
        for src, dst in copies:
            kv_cache.copy_page(self.cache, src, dst)

    # -- the serving loop -----------------------------------------------------

    def _apply_swap(self, swap: Optional[tuple[int, int]]) -> None:
        if swap is None:
            return
        i, j = swap
        if self.paged:
            # Compaction under paging is a host page-table pointer swap.
            self._paging.swap_slots(i, j)
        else:
            kv_cache.swap_slots(self.cache, i, j)
        self._tokens[[i, j]] = self._tokens[[j, i]]
        self._lengths[[i, j]] = self._lengths[[j, i]]

    def _release_pages(self, req: Request) -> None:
        """Paged reclaim for a request that just left its slot: index its
        prompt for future prefix hits, then drop the slot's page
        references. Must run BEFORE the mirrored slot swap, while the
        allocator row still belongs to this request."""
        if self.paged and req.released_slot is not None:
            # Bound prefix registration to positions actually written: a
            # request evicted mid-chunked-prefill holds allocated pages
            # past its cursor whose K/V are garbage.
            upto = min(req.prefill_pos, len(req.prompt))
            self._paging.finish(req.released_slot, req.prompt, upto=upto)
            req.released_slot = None

    def _retire(self, req: Request, *, now: float, status: str) -> None:
        swap = self.scheduler.finish(req, now=now, status=status)
        self._release_pages(req)
        self._apply_swap(swap)
        self.finished.append(req)
        if self.journal is not None:
            self.journal.record_finish(req)
        if status == DONE:
            self._done_count += 1
            metrics.inc("serve.requests.completed")
            if req.latency_s is not None:
                metrics.observe_value("serve.request.latency_s",
                                      req.latency_s)
            if req.ttft_s is not None:
                metrics.observe_value("serve.request.ttft_s", req.ttft_s)
        else:
            metrics.inc("serve.requests.evicted")

    def _total_tokens(self, req: Request) -> int:
        """Worst-case positions this request can occupy — the paged
        admission/reservation unit."""
        return min(len(req.prompt) + len(req.generated)
                   + max(req.max_new_tokens - len(req.generated), 0),
                   self.max_len)

    def _admission_gate(self, req: Request) -> bool:
        """Paged admission: the pool must also hold this request's worst
        case. Reserving up front keeps every later incremental allocation
        (decode appends, COW clones) deadlock-free."""
        return self._paging.try_admit(self._total_tokens(req))

    def _paged_prefill(self, req: Request, seq: list, start: int, end: int,
                       pad: int):
        """``kv_cache.paged_prefill`` over ``seq[start:end]`` padded to
        ``pad``; returns the logits of position ``end - 1``. An int8 pool's
        max-abs dequantization error goes into the
        ``serve.kv.quant_error`` distribution."""
        tokens = np.zeros(pad, np.int64)
        tokens[:end - start] = seq[start:end]
        out = self._run(
            "paged_prefill", pad,
            functools.partial(kv_cache.paged_prefill, self.plan, self.cache),
            page_row=self._paging.allocator.table[req.slot], tokens=tokens,
            length=end, start=start)
        if not self._kv_quant:
            return out
        logits, qerr = out
        metrics.observe_value("serve.kv.quant_error", float(qerr))
        return logits

    def _first_token(self, req: Request, logits, plen: int) -> None:
        """Sample the first generated token from the prefill's logits (on
        the host, so the first-token time is stamped after the device
        finished) and retire the request if that was all it needed."""
        metrics.inc("serve.prefills")
        token = self._pick(logits.float().cpu().numpy())
        now = self.clock()
        done = self.scheduler.record_token(req, token, now=now)
        metrics.inc("serve.tokens.generated")
        if self.journal is not None:
            self.journal.record_token(req.rid, token)
        self._tokens[req.slot] = token
        self._lengths[req.slot] = plen
        if done or plen >= self.max_len:
            self._retire(req, now=now, status=DONE)

    def _prefill(self, req: Request) -> None:
        if self.prefill_chunk:
            self._begin_chunked_prefill(req)
            return
        seq = list(req.prompt) + list(req.generated)
        plen = len(seq)
        with torch.inference_mode():
            if self.paged:
                setup = self._paging.begin(req.slot, seq,
                                           self._total_tokens(req))
                self._copy_pages(setup.copies)
                pad = _pad_to_pow2(plen - setup.start, hi=self.max_len)
                logits = self._paged_prefill(req, seq, setup.start, plen,
                                             pad)
                self._paging.register_prefill(req.slot, req.prompt)
            else:
                pad = _pad_to_pow2(plen, hi=self.max_len)
                tokens = np.zeros(pad, np.int64)
                tokens[:plen] = seq
                logits = self._run(
                    "prefill", pad,
                    functools.partial(kv_cache.prefill, self.plan,
                                      self.cache),
                    tokens=tokens, length=plen, slot=req.slot)
        req.prefill_pos = plen
        self._first_token(req, logits, plen)

    def _begin_chunked_prefill(self, req: Request) -> None:
        """Admission under ``prefill_chunk > 0``: set up the slot (page
        table and prefix-cache attach in paged mode; allocation is
        chunk-granular from here on) and put the request on the chunk
        queue. No forward pass runs yet; :meth:`step` drains chunks
        interleaved with decode."""
        seq = list(req.prompt) + list(req.generated)
        if self.paged:
            setup = self._paging.begin(req.slot, seq,
                                       self._total_tokens(req),
                                       chunk=self.prefill_chunk)
            with torch.inference_mode():
                self._copy_pages(setup.copies)
            req.prefill_pos = setup.start
        else:
            req.prefill_pos = 0
        # Mirror the cursor: a mid-prefill slot rides inside the decode
        # bucket, so decode writes one garbage K/V at exactly
        # lengths[slot] — the next unwritten position, which the next
        # chunk overwrites before any mask admits it.
        self._tokens[req.slot] = 0
        self._lengths[req.slot] = req.prefill_pos
        self.scheduler.enqueue_prefill(req)

    def _prefill_chunk_one(self, req: Request) -> None:
        """Run ONE chunk of ``req``'s prefill: positions ``[prefill_pos,
        min(prefill_pos + prefill_chunk, plen))``. The final chunk yields
        the first generated token and moves the request into decode."""
        seq = list(req.prompt) + list(req.generated)
        plen = len(seq)
        start = req.prefill_pos
        end = min(start + self.prefill_chunk, plen)
        pad = _pad_to_pow2(end - start, hi=self.prefill_chunk)
        with torch.inference_mode():
            if self.paged:
                self._paging.extend_prefill(req.slot, end)
                logits = self._paged_prefill(req, seq, start, end, pad)
            else:
                tokens = np.zeros(pad, np.int64)
                tokens[:end - start] = seq[start:end]
                logits = self._run(
                    "prefill_chunk", pad,
                    functools.partial(kv_cache.prefill_chunk_step,
                                      self.plan, self.cache),
                    tokens=tokens, length=end, slot=req.slot, start=start)
        req.prefill_pos = end
        self._lengths[req.slot] = end
        metrics.inc("serve.prefill.chunks")
        if end < plen:
            return  # more chunks owed; a mid-chunk's logits are unused
        self.scheduler.dequeue_prefill(req)
        if self.paged:
            self._paging.register_prefill(req.slot, req.prompt)
        self._first_token(req, logits, plen)

    def step(self) -> int:
        """One scheduling round: deadline evictions -> admissions (each
        pays its prefill and emits its first token, or joins the chunk
        queue) -> up to ``prefill_interleave`` prefill chunks -> one decode
        step for the bucket. Returns the number of still-active requests.

        Durability: everything journaled this round (submits, tokens,
        finishes) is flushed — one append and one fsync — at the END of
        the round, after the fault injector's seams, so an injected crash
        loses the unflushed tail and recovery must regenerate it."""
        now = self.clock()
        for req, swap in self.scheduler.evict_deadline(now=now):
            self._release_pages(req)
            self._apply_swap(swap)
            self.finished.append(req)
            metrics.inc("serve.requests.evicted")
            if self.journal is not None:
                self.journal.record_finish(req)
        gate = self._admission_gate if self.paged else None
        for req in self.scheduler.admit(gate=gate):
            self._prefill(req)
        metrics.set_gauge("serve.queue.depth", self.scheduler.queue_depth())
        if self.prefill_chunk:
            for _ in range(self.prefill_interleave):
                head = self.scheduler.peek_prefill()
                if head is None:
                    break
                self._prefill_chunk_one(head)
        if self.paged:
            self._paging.note_usage()
        n = self.scheduler.num_active
        # Decode covers only fully prefilled slots (all active ones when
        # chunking is off).
        ready = self.scheduler.ready()
        if not ready:
            if self.journal is not None:
                self.journal.flush()
            return n
        # A ragged engine decodes every slot in one program, so occupancy
        # is measured against the whole capacity.
        bucket = self.max_batch if self.ragged else self.scheduler.bucket()
        metrics.observe_value("serve.batch.occupancy", len(ready) / bucket)
        with torch.inference_mode():
            if self.paged:
                # This round's appends: a page boundary allocates the next
                # page (covered by the admission reservation); a tail page
                # shared with the prefix cache is copied private first.
                for req in ready:
                    self._copy_pages(self._paging.prepare_append(
                        req.slot, int(self._lengths[req.slot])))
            t0 = self.clock()
            timer = None
            if self.stall_timeout_s is not None:
                info = {"timeout_s": self.stall_timeout_s, "bucket": bucket,
                        "active": n}
                timer = threading.Timer(self.stall_timeout_s,
                                        self.stall_action, args=(info,))
                timer.daemon = True
                timer.start()
            try:
                logits = self._decode(bucket, ready)
                if self.fault_injector is not None:
                    # Inside the watchdog window on purpose: a decode_stall
                    # fault must look exactly like a hung device call.
                    self.fault_injector.on_decode()
                logits = logits.cpu().numpy()  # waits for the device
            finally:
                if timer is not None:
                    timer.cancel()
        metrics.inc("serve.decode.steps")
        if self.virtual_step_s > 0.0 and hasattr(self.clock, "advance"):
            self.clock.advance(self.virtual_step_s)
        dt = self.clock() - t0
        if dt > 0.0:
            self._step_ema_s = (dt if self._step_ema_s is None else
                                _EMA_ALPHA * dt
                                + (1.0 - _EMA_ALPHA) * self._step_ema_s)
        now = self.clock()
        completed = []
        for req in ready:
            token = self._pick(logits[req.slot])
            self._lengths[req.slot] += 1
            self._tokens[req.slot] = token
            done = self.scheduler.record_token(req, token, now=now)
            metrics.inc("serve.tokens.generated")
            if self.journal is not None:
                self.journal.record_token(req.rid, token)
            if done or self._lengths[req.slot] >= self.max_len:
                completed.append(req)
        # Highest slot first: each swap moves the (untouched) last slot.
        for req in sorted(completed, key=lambda r: r.slot, reverse=True):
            self._retire(req, now=now, status=DONE)
        if self.fault_injector is not None:
            self.fault_injector.on_step_end(self._done_count)
        if self.journal is not None:
            self.journal.flush()
        return self.scheduler.num_active

    def _decode(self, bucket: int, ready: list) -> torch.Tensor:
        """Dispatch one decode step over ``bucket`` slots; returns the
        logits on the device (on CUDA the replay may still be running)."""
        if not self.paged:
            return self._run(
                "decode", bucket,
                functools.partial(kv_cache.decode_step, self.plan,
                                  self.cache, bucket=bucket),
                tokens=self._tokens, lengths=self._lengths)
        decode = dict(page_tables=self._paging.allocator.table,
                      tokens=self._tokens, lengths=self._lengths)
        if self.ragged:
            # Only fully prefilled slots write their real tail pages: empty
            # slots and slots in the middle of a chunked prefill (whose
            # rows hold real pages) write to the scratch page.
            active = np.zeros(self.max_batch, bool)
            active[[r.slot for r in ready]] = True
            return self._run(
                "paged_decode", bucket,
                functools.partial(kv_cache.paged_decode_ragged, self.plan,
                                  self.cache),
                active=active, **decode)
        return self._run(
            "paged_decode", bucket,
            functools.partial(kv_cache.paged_decode_step, self.plan,
                              self.cache, bucket=bucket), **decode)

    def run_until_idle(self, *, max_steps: int = 100_000) -> list[Request]:
        """Drive :meth:`step` until queue and batch drain; returns all
        requests finished so far (done + evicted, completion order)."""
        steps = 0
        while not self.scheduler.idle():
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"serve loop still busy after {max_steps} steps "
                    f"({self.scheduler.num_active} active, "
                    f"{self.scheduler.queue_depth()} queued)")
        return self.finished

    def generate(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None) -> list[int]:
        """Single-request convenience: submit, drain, return the tokens."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          eos_id=eos_id)
        self.run_until_idle()
        return req.generated

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Flush and close the journal and drop readiness. Idempotent; a
        crash skips it by definition — that is what recovery is for."""
        if self._closed:
            return
        self._closed = True
        metrics.set_gauge("serve.ready", 0.0)
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
