"""Tracing and live telemetry, copied from the JAX package."""
from repro_torch.obs.live import Histogram
from repro_torch.obs.trace import RoundTrace, Span, Tracer, read_traces

__all__ = ["Histogram", "RoundTrace", "Span", "Tracer", "read_traces"]
