"""repro.online — the streaming control plane.

The Platform as a long-lived service: arrival streams (``TraceStream``,
``StreamHandle``), the ``OnlineController`` (admission with SLA classes,
aggregator-pool autoscaling) and tumbling-window metrics
(``WindowedFleetMetrics``). Entry point: ``Platform.serve(stream, ...)``.
"""
from repro_torch.online.controller import (
    SLA_CLASSES,
    AdmissionConfig,
    AutoscalerConfig,
    ClassStats,
    OnlineController,
    OnlineReport,
    SLAClass,
)
from repro_torch.online.stream import (
    ArrivalStream,
    StreamHandle,
    TraceStream,
)
from repro_torch.online.window import WindowedFleetMetrics, WindowStats

__all__ = [
    "ArrivalStream",
    "TraceStream",
    "StreamHandle",
    "OnlineController",
    "OnlineReport",
    "SLAClass",
    "SLA_CLASSES",
    "AdmissionConfig",
    "AutoscalerConfig",
    "ClassStats",
    "WindowedFleetMetrics",
    "WindowStats",
]
