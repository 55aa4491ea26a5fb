"""``repro.obs.registry`` — a lightweight counter/histogram registry.

Snapshot-able at any sim time: ``snapshot(t)`` returns a plain-dict view
(counters + histogram summary stats) stamped with the sim time the caller
passes in — the registry itself never touches a clock, so snapshots are
deterministic and diffable across runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["Counter", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically increasing named count."""

    __slots__ = ("name", "n")

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def inc(self, by: int = 1) -> None:
        self.n += by


class Histogram:
    """A named sample set with summary statistics (exact quantiles over
    retained samples — sample counts here are sim-scale, not prod-scale)."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(value)

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def summary(self) -> Dict[str, object]:
        if not self.samples:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p95": None}
        total = sum(self.samples)
        return {
            "count": len(self.samples),
            "sum": total,
            "mean": total / len(self.samples),
            "min": min(self.samples),
            "max": max(self.samples),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
        }


class MetricsRegistry:
    """Get-or-create named counters and histograms."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def snapshot(self, t: Optional[float] = None) -> Dict[str, object]:
        """A plain-dict view of every metric, stamped with the caller's
        sim time (the registry holds no clock of its own)."""
        return {
            "t": t,
            "counters": {k: c.n for k, c in sorted(self.counters.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }
