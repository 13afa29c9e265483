"""Telemetry of the port (counterpart of `torched_impala_tpu/telemetry/`):
the metrics registry (`registry.py`), the flight recorder (`tracing.py`),
burn-rate alerts (`alerts.py`) and the training-health plane with its
postmortem bundles (`health.py`). The rest of the JAX package's telemetry
(watchdog, export, aggregation, profiler capture) is not ported yet
(ROADMAP.md queue 1: "Observability, perf and control").
"""

from torched_impala_tpu_torch.telemetry.alerts import AlertEngine, SloSpec
from torched_impala_tpu_torch.telemetry.health import (
    HEALTH_LOG_PREFIX,
    HealthMonitor,
    PostmortemWriter,
    health_slo_specs,
)
from torched_impala_tpu_torch.telemetry.registry import (
    DEFAULT_MS_BUCKETS,
    NAME_RE,
    PREFIX,
    Counter,
    EwmaTimer,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_enabled,
)
from torched_impala_tpu_torch.telemetry.tracing import (
    FlightRecorder,
    get_recorder,
    mint_lineage_id,
    set_trace_enabled,
    validate_chrome_trace,
)

__all__ = [
    "DEFAULT_MS_BUCKETS",
    "NAME_RE",
    "PREFIX",
    "Counter",
    "EwmaTimer",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "set_enabled",
    "FlightRecorder",
    "get_recorder",
    "mint_lineage_id",
    "set_trace_enabled",
    "validate_chrome_trace",
    "AlertEngine",
    "SloSpec",
    "HEALTH_LOG_PREFIX",
    "HealthMonitor",
    "PostmortemWriter",
    "health_slo_specs",
]
