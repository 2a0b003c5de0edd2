"""Fleet observatory: event-sourced tracing, a dependency-free metrics
registry with exact cross-shard merge, and carbon/SLA attribution
rollups. Copies of the reference's ``core/obs`` modules.
"""
from repro_torch.core.obs.metrics import (Counter, Gauge, Histogram,
                                          MetricsRegistry, log_bounds, merged,
                                          to_json, to_prometheus)
from repro_torch.core.obs.observer import (FleetObserver, ObsConfig,
                                           as_observer)
from repro_torch.core.obs.pmeter_bridge import observe_pmeter
from repro_torch.core.obs.rollup import CarbonLedgerView, JobRow
from repro_torch.core.obs.trace import (JsonlSink, RingSink, Span, TraceSink,
                                        emit_all, load_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_bounds",
    "merged", "to_json", "to_prometheus",
    "FleetObserver", "ObsConfig", "as_observer",
    "observe_pmeter",
    "CarbonLedgerView", "JobRow",
    "JsonlSink", "RingSink", "Span", "TraceSink", "emit_all", "load_jsonl",
]
