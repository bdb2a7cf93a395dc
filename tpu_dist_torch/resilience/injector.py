"""ServeFaultInjector: executes the serve slice of a FaultPlan.

Counterpart of ``tpu_dist/resilience/injector.py``'s serve half
(``ServeFaultInjector`` and ``maybe_serve_injector_from_env``). The
training ``FaultInjector`` callback and the ``PreemptionDrain`` and
``RejoinGate`` callbacks are not ported yet (ROADMAP.md queue 1, item 18).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import FaultPlan, FaultSpec

logger = logging.getLogger("tpu_dist_torch.resilience")


class ServeFaultInjector:
    """Executes the SERVE slice of a FaultPlan from inside the engine loop.

    Not a training callback — the :class:`~tpu_dist_torch.serve.engine.
    ServeEngine` calls the two seams directly each decode round:

    * ``on_decode()`` — between the decode dispatch and the host read of
      its logits, inside the engine's stall-watchdog window: a due
      ``decode_stall`` sleeps there, indistinguishable from a hung device
      call, so the watchdog (not the injector) ends the process.
    * ``on_step_end(done_count)`` — after retirements but BEFORE the
      journal flush: a due ``engine_crash@reqN`` (fires once
      ``done_count`` reaches N completed requests) is ``os._exit`` with
      the journal's unflushed tail lost, the harsher recovery case for the
      parity gate.

    ``request_storm`` is a submission-side fault: the chaos runner
    (``serve/chaos.py``) interprets it, not this injector.
    """

    ENGINE_KINDS = ("engine_crash", "decode_stall")

    def __init__(self, faults: Sequence[FaultSpec],
                 event_log: Optional[events.EventLog] = None):
        self.faults = [f for f in faults if f.kind in self.ENGINE_KINDS]
        self._events = event_log
        self._remaining = [f.count for f in self.faults]
        self._done = 0

    def _log(self, event: str, **fields) -> None:
        try:
            log = self._events or events.log_from_env()
            if log is not None:
                log.append(event, attempt=events.current_attempt(), **fields)
        except OSError:
            pass

    def arm(self) -> "ServeFaultInjector":
        for f in self.faults:
            self._log("fault_armed", kind=f.kind, req=f.req)
        if events.current_attempt() > 0:
            self._log("resumed")
        return self

    def on_decode(self) -> None:
        for i, f in enumerate(self.faults):
            if (f.kind != "decode_stall" or self._remaining[i] <= 0
                    or not f.due_at_req(self._done)):
                continue
            self._remaining[i] -= 1
            self._log("fault_fired", kind="decode_stall", req=f.req,
                      seconds=f.seconds)
            logger.warning("fault injection: stalling decode step for "
                           "%.1fs (after %d completed)", f.seconds,
                           self._done)
            time.sleep(f.seconds)

    def on_step_end(self, done_count: int) -> None:
        self._done = int(done_count)
        for i, f in enumerate(self.faults):
            if (f.kind != "engine_crash" or self._remaining[i] <= 0
                    or not f.due_at_req(done_count)):
                continue
            self._remaining[i] -= 1
            self._log("fault_fired", kind="engine_crash", req=f.req,
                      done=done_count, exit_code=f.exit_code)
            logger.warning("fault injection: killing serve engine after "
                           "%d completed requests (exit %d)", done_count,
                           f.exit_code)
            os._exit(f.exit_code)


def maybe_serve_injector_from_env(*, attempt: Optional[int] = None
                                  ) -> Optional[ServeFaultInjector]:
    """This serve process's injector from ``$TPU_DIST_FAULT_PLAN``, or None
    when no plan is set or no engine-side serve fault targets this attempt
    (serve workers are single-process: rank 0)."""
    plan = FaultPlan.from_env()
    if not plan:
        return None
    if attempt is None:
        attempt = events.current_attempt()
    mine = [f for f in plan.for_process(0, attempt)
            if f.kind in ServeFaultInjector.ENGINE_KINDS]
    if not mine:
        return None
    logger.info("serve fault plan armed for attempt %d: %d fault(s)",
                attempt, len(mine))
    return ServeFaultInjector(mine).arm()
