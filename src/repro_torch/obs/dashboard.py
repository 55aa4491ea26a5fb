"""``repro.obs.dashboard`` — the structured live view served by
``OnlineController.dashboard()``.

A ``DashboardView`` is a frozen snapshot of the control plane at one sim
time: per-class admission/backlog/preemption state, pool occupancy, and
the trailing window summaries from ``poll()``. It is plain data (``
as_dict()`` round-trips through JSON) so a real serving layer could ship
it over a wire verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["DashboardView"]


@dataclasses.dataclass(frozen=True)
class DashboardView:
    """One live snapshot of the online control plane."""

    t: float
    strategy: str
    done: bool
    #: capacity / running / pending / occupancy (instantaneous) / peak /
    #: scale_ups / scale_downs
    pool: Dict[str, object]
    #: raw and class-weighted drain backlog (the autoscaler's signal)
    backlog: Dict[str, float]
    #: burst flag, arrivals in the trailing window, queue depth now
    admission: Dict[str, object]
    #: per-SLA-class summaries (arrived/admitted/queued/shed/preemptions/
    #: p95 lateness) plus live queue depth per class
    classes: Dict[str, Dict[str, object]]
    #: active / completed / shed job counts
    jobs: Dict[str, int]
    #: trailing tumbling-window summaries (most recent last)
    windows: List[Dict[str, object]]
    #: optional metrics-registry snapshot (present when tracing is on)
    metrics: Optional[Dict[str, object]] = None

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)
