"""tpu_dist_torch.resilience — fault plans, fault injection and supervised
restart.

Counterpart of ``tpu_dist/resilience``: the deterministic fault grammar
(:mod:`~tpu_dist_torch.resilience.faults`), the shared event log
(:mod:`~tpu_dist_torch.resilience.events`), the training and serve fault
injectors and the preemption drain
(:mod:`~tpu_dist_torch.resilience.injector`), the mid-epoch gang reform
(:mod:`~tpu_dist_torch.resilience.rejoin`), the elastic supervision loop
(:mod:`~tpu_dist_torch.resilience.supervisor`), the supervised entry point
(:mod:`~tpu_dist_torch.resilience.entrypoints`) and the chaos runner
``python -m tpu_dist_torch.resilience`` (:mod:`~tpu_dist_torch.resilience.
cli`).
"""

from tpu_dist_torch.resilience.events import (ATTEMPT_ENV, EVENT_LOG_ENV,
                                              EventLog, current_attempt,
                                              maybe_log, read_events)
from tpu_dist_torch.resilience.faults import (EXIT_FAULT_KILL,
                                              EXIT_PEER_UNAVAILABLE,
                                              FAULT_PLAN_ENV, FaultPlan,
                                              FaultSpec, describe)
from tpu_dist_torch.resilience.injector import (FaultInjector,
                                                maybe_injector_from_env)
from tpu_dist_torch.resilience.rejoin import (GangReform, StepRejoinGate,
                                              maybe_step_rejoin_gate)
from tpu_dist_torch.resilience.supervisor import (BackoffPolicy, Supervisor,
                                                  SupervisorReport)

__all__ = [
    "ATTEMPT_ENV", "EVENT_LOG_ENV", "EventLog", "current_attempt",
    "maybe_log", "read_events",
    "EXIT_FAULT_KILL", "EXIT_PEER_UNAVAILABLE", "FAULT_PLAN_ENV",
    "FaultPlan", "FaultSpec", "describe",
    "FaultInjector", "maybe_injector_from_env",
    "BackoffPolicy", "Supervisor", "SupervisorReport",
    "GangReform", "StepRejoinGate", "maybe_step_rejoin_gate",
]
