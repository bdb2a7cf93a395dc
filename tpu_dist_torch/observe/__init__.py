"""Observability layer: the in-process metrics registry, the exporters
(schema-versioned JSONL series, Prometheus textfiles), straggler and
heartbeat detection, and the ``Telemetry`` fit callback with its step
timer (``python -m tpu_dist_torch.observe`` runs the CLI).

Telemetry pulls in the training stack, so it loads on first use
(``__getattr__``), as in the reference: ``from tpu_dist_torch.observe
import metrics`` stays cheap everywhere.
"""

from tpu_dist_torch.observe.exporters import (SCHEMA, JsonlExporter,
                                              SchemaError, read_series,
                                              write_prometheus_textfile)
from tpu_dist_torch.observe.metrics import (MetricsRegistry, disable, enable,
                                            enabled, get_registry, inc,
                                            observe_value, set_gauge)
from tpu_dist_torch.observe.straggler import (HeartbeatMonitor,
                                              StragglerVerdict,
                                              detect_stragglers)

__all__ = [
    "SCHEMA", "JsonlExporter", "SchemaError", "read_series",
    "write_prometheus_textfile",
    "MetricsRegistry", "disable", "enable", "enabled", "get_registry",
    "inc", "observe_value", "set_gauge",
    "HeartbeatMonitor", "StragglerVerdict", "detect_stragglers",
    "OBSERVE_DIR_ENV", "StepTimer", "Telemetry", "active_step_timer",
    "maybe_telemetry_from_env",
]

_LAZY = ("OBSERVE_DIR_ENV", "StepTimer", "Telemetry", "active_step_timer",
         "maybe_telemetry_from_env")


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from tpu_dist_torch.observe import telemetry

    return getattr(telemetry, name)
