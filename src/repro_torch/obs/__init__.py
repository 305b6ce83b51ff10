"""repro_torch.obs — event-driven tracing + telemetry (paper §4.3).

See README.md in this package for the paper mapping; trace.py for the
span/trace machinery, live.py for streaming histograms and the fleet
monitor (the agent's periodic live drain), export.py for the
Prometheus/human renderers.  The instrumentation hook points live in
the components themselves (runtime/driver.py, runtime/shmrt,
runtime/netrt) — this package only defines the sample types and the
merge/accounting layer, keeping the "zero cost when idle" contract
auditable in one place.
"""
from repro_torch.obs.export import summary_line, to_prometheus
from repro_torch.obs.live import FleetMonitor, Histogram, SLOTarget, SLOTracker
from repro_torch.obs.trace import (
    NULL_TRACER,
    RoundTrace,
    SPAN_KINDS,
    Span,
    Tracer,
    read_traces,
    span_from_wire,
    span_to_wire,
    write_trace,
)

__all__ = [
    "FleetMonitor",
    "Histogram",
    "NULL_TRACER",
    "RoundTrace",
    "SLOTarget",
    "SLOTracker",
    "SPAN_KINDS",
    "Span",
    "Tracer",
    "read_traces",
    "span_from_wire",
    "span_to_wire",
    "summary_line",
    "to_prometheus",
    "write_trace",
]
