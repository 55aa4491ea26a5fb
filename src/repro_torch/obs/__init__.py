"""Sim-time tracing and the metrics registry the simulated cluster reports
into (the dashboard stays with a later slice)."""
from repro_torch.obs.registry import Counter, Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Span,
    TraceEvent,
    Tracer,
)
