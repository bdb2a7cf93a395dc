"""Serving layer: the continuous-batching engine over a contiguous KV
cache or a paged KV pool with prefix caching, chunked prefill and int8
pages (``python -m tpu_dist_torch.serve [--paged]`` runs it), and its
resilience: the durable ``RequestJournal`` a ``ServeSupervisor``-restarted
engine recovers from, load shedding and the decode-stall watchdog
(``python -m tpu_dist_torch.serve --chaos`` runs the gated chaos suite)."""

from tpu_dist_torch.serve.engine import ServeEngine
from tpu_dist_torch.serve.journal import JournalState, RequestJournal
from tpu_dist_torch.serve.kv_cache import (DecodePlan, build_plan,
                                           decode_step, init_cache, prefill)
from tpu_dist_torch.serve.scheduler import (DONE, EVICTED, SHED, Request,
                                            Scheduler, default_buckets)
from tpu_dist_torch.serve.supervisor import ServeSupervisor

__all__ = [
    "ServeEngine", "DecodePlan", "build_plan", "decode_step", "init_cache",
    "prefill", "Request", "Scheduler", "default_buckets",
    "RequestJournal", "JournalState", "ServeSupervisor",
    "DONE", "EVICTED", "SHED",
]
