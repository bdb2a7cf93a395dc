"""ServeEngine: the continuous-batching inference loop on one device.

Counterpart of the contiguous-cache path of ``tpu_dist/serve/engine.py``.
Scheduling stays host-side in ``scheduler.py``, math in ``kv_cache.py``;
the engine owns the model on its device, the KV cache and the host mirrors
of per-slot decode state:

* prompts pad up to a power of two (at least 8, at most ``max_len``) and
  each admitted request pays one prefill, which emits its first token;
* each :meth:`step` runs one decode step over the scheduler's bucket (the
  smallest power of two covering the active slots);
* a freed slot is compacted by swapping the last active slot down, and
  the engine mirrors the swap in the cache (``kv_cache.swap_slots``).

PyTorch runs eagerly, so there are no compiled programs to cache;
:meth:`compiled_programs` reports the prefill pad lengths and decode
buckets used, the reference's program families, so summaries keep their
shape. Every step emits host-side metrics (``observe/metrics.py``) under the
reference's names. The journal, load shedding, stall watchdog, jobs
runtime, paging and chunked prefill come later in the port.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.serve import kv_cache
from tpu_dist_torch.serve.scheduler import DONE, Request, Scheduler
from tpu_dist_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_MIN_PROMPT_PAD = 8


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
      policy: ``continuous`` or ``static`` (see :class:`Scheduler`).
      temperature: 0 = greedy argmax; > 0 samples from the tempered softmax
        with a host-side generator seeded by ``seed``.
      cache_dtype: KV cache dtype.
      device: ``None`` (the CUDA device; raises without one) or an explicit
        device such as ``"cpu"``.
    """

    def __init__(self, model: Sequential, *, max_batch: int = 8,
                 max_len: Optional[int] = None, policy: str = "continuous",
                 temperature: float = 0.0, seed: int = 0,
                 cache_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.plan = kv_cache.build_plan(model)
        self.max_len = int(max_len or self.plan.max_position)
        if self.max_len > self.plan.max_position:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's positional "
                f"table ({self.plan.max_position})")
        self.max_batch = int(max_batch)
        self.temperature = float(temperature)
        self.clock = time.monotonic
        self._rng = np.random.default_rng(seed)
        self.cache = kv_cache.init_cache(
            self.plan, max_batch=self.max_batch, max_len=self.max_len,
            dtype=cache_dtype, device=self.device)
        logger.info(
            "serve: %d slots x %d positions on %s, KV cache %.1f MiB",
            self.max_batch, self.max_len, self.device,
            kv_cache.cache_nbytes(self.plan, max_batch=self.max_batch,
                                  max_len=self.max_len,
                                  dtype=cache_dtype) / 2**20)
        self.scheduler = Scheduler(self.max_batch, policy=policy)
        # Host mirrors of per-slot decode state (compacted with the
        # scheduler's slot moves).
        self._tokens = np.zeros(self.max_batch, np.int64)
        self._lengths = np.zeros(self.max_batch, np.int64)
        self.finished: list[Request] = []
        self._decode_buckets: set[int] = set()
        self._prefill_pads: set[int] = set()

    def compiled_programs(self) -> dict:
        """``{'decode': [buckets...], 'prefill': [pad_lens...]}`` used so
        far — the reference's program families."""
        return {"decode": sorted(self._decode_buckets),
                "prefill": sorted(self._prefill_pads)}

    # -- request intake -------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens does not fit a "
                f"{self.max_len}-position cache slot (need >= 1 free)")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, deadline_s=deadline_s)
        self.scheduler.submit(req, now=self.clock())
        metrics.inc("serve.requests.submitted")
        return req

    # -- sampling (host-side) -------------------------------------------------

    def _pick(self, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        return int(self._rng.choice(logits.shape[-1], p=p / p.sum()))

    # -- the serving loop -----------------------------------------------------

    def _apply_swap(self, swap: Optional[tuple[int, int]]) -> None:
        if swap is None:
            return
        i, j = swap
        kv_cache.swap_slots(self.cache, i, j)
        self._tokens[[i, j]] = self._tokens[[j, i]]
        self._lengths[[i, j]] = self._lengths[[j, i]]

    def _retire(self, req: Request, *, now: float, status: str) -> None:
        self._apply_swap(self.scheduler.finish(req, now=now, status=status))
        self.finished.append(req)
        if status == DONE:
            metrics.inc("serve.requests.completed")
            if req.latency_s is not None:
                metrics.observe_value("serve.request.latency_s",
                                      req.latency_s)
            if req.ttft_s is not None:
                metrics.observe_value("serve.request.ttft_s", req.ttft_s)
        else:
            metrics.inc("serve.requests.evicted")

    def _prefill(self, req: Request) -> None:
        seq = list(req.prompt) + list(req.generated)
        plen = len(seq)
        pad = _pad_to_pow2(plen, hi=self.max_len)
        tokens = np.zeros(pad, np.int64)
        tokens[:plen] = seq
        self._prefill_pads.add(pad)
        with torch.inference_mode():
            logits = kv_cache.prefill(
                self.plan, self.cache,
                torch.from_numpy(tokens).to(self.device), plen, req.slot)
            logits = logits.float().cpu().numpy()
        metrics.inc("serve.prefills")
        # Stamp the first-token time only after the logits reached the host.
        token = self._pick(logits)
        now = self.clock()
        done = self.scheduler.record_token(req, token, now=now)
        metrics.inc("serve.tokens.generated")
        self._tokens[req.slot] = token
        self._lengths[req.slot] = plen
        if done or plen >= self.max_len:
            self._retire(req, now=now, status=DONE)

    def step(self) -> int:
        """One scheduling round: deadline evictions -> admissions (each
        pays its prefill and emits its first token) -> one decode step for
        the active bucket. Returns the number of still-active requests."""
        now = self.clock()
        for req, swap in self.scheduler.evict_deadline(now=now):
            self._apply_swap(swap)
            self.finished.append(req)
            metrics.inc("serve.requests.evicted")
        for req in self.scheduler.admit():
            self._prefill(req)
        metrics.set_gauge("serve.queue.depth", self.scheduler.queue_depth())

        ready = self.scheduler.active()
        if not ready:
            return self.scheduler.num_active
        bucket = self.scheduler.bucket()
        self._decode_buckets.add(bucket)
        metrics.observe_value("serve.batch.occupancy", len(ready) / bucket)
        with torch.inference_mode():
            logits = kv_cache.decode_step(
                self.plan, self.cache,
                torch.from_numpy(self._tokens).to(self.device),
                torch.from_numpy(self._lengths).to(self.device),
                bucket=bucket)
            logits = logits.cpu().numpy()  # waits for the device
        metrics.inc("serve.decode.steps")
        now = self.clock()
        completed = []
        for req in ready:
            token = self._pick(logits[req.slot])
            self._lengths[req.slot] += 1
            self._tokens[req.slot] = token
            done = self.scheduler.record_token(req, token, now=now)
            metrics.inc("serve.tokens.generated")
            if done or self._lengths[req.slot] >= self.max_len:
                completed.append(req)
        # Highest slot first: each swap moves the (untouched) last slot.
        for req in sorted(completed, key=lambda r: r.slot, reverse=True):
            self._retire(req, now=now, status=DONE)
        return self.scheduler.num_active

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
