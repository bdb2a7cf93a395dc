"""Observability layer: the in-process metrics registry (counters, gauges,
reservoir-sampled distributions)."""

from tpu_dist_torch.observe.metrics import (MetricsRegistry, disable, enable,
                                            enabled, get_registry, inc,
                                            observe_value, set_gauge)

__all__ = [
    "MetricsRegistry", "disable", "enable", "enabled", "get_registry",
    "inc", "observe_value", "set_gauge",
]
