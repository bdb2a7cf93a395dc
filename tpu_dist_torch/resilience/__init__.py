"""tpu_dist_torch.resilience — fault plans, the serve fault injector and
supervised restart.

Counterpart of ``tpu_dist/resilience``: the deterministic fault grammar
(:mod:`~tpu_dist_torch.resilience.faults`), the shared event log
(:mod:`~tpu_dist_torch.resilience.events`), the serve engine's injector
(:mod:`~tpu_dist_torch.resilience.injector`) and the supervision loop
(:mod:`~tpu_dist_torch.resilience.supervisor`). The training
``FaultInjector``, the gang reform and the step rejoin gate are ROADMAP.md
queue 1, item 18.
"""

from tpu_dist_torch.resilience.events import (ATTEMPT_ENV, EVENT_LOG_ENV,
                                              EventLog, current_attempt,
                                              maybe_log, read_events)
from tpu_dist_torch.resilience.faults import (EXIT_FAULT_KILL,
                                              EXIT_PEER_UNAVAILABLE,
                                              FAULT_PLAN_ENV, FaultPlan,
                                              FaultSpec, describe)
from tpu_dist_torch.resilience.supervisor import (BackoffPolicy, Supervisor,
                                                  SupervisorReport)

__all__ = [
    "ATTEMPT_ENV", "EVENT_LOG_ENV", "EventLog", "current_attempt",
    "maybe_log", "read_events",
    "EXIT_FAULT_KILL", "EXIT_PEER_UNAVAILABLE", "FAULT_PLAN_ENV",
    "FaultPlan", "FaultSpec", "describe",
    "BackoffPolicy", "Supervisor", "SupervisorReport",
]
