"""``repro.obs`` — sim-time tracing, metrics, and the live dashboard.

Zero-overhead when disabled: every component defaults to the shared
``NULL_TRACER`` singleton and guards emission on ``tracer.enabled``.
Enable by passing a ``Tracer`` via ``Platform(tracer=...)`` or
``Platform.serve(..., trace=...)``; export with
``tracer.export_chrome(path)`` (Perfetto-loadable) and reconcile billing
with ``tracer.reconcile(cluster)``.
"""
from repro_torch.obs.dashboard import DashboardView
from repro_torch.obs.registry import Counter, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, TraceEvent, Tracer

__all__ = [
    "Counter",
    "DashboardView",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "TraceEvent",
    "Tracer",
]
