"""Metrics per §6.2: aggregation latency (per round, reported as the mean
over rounds) and container-seconds -> projected cost (Azure ACI pricing)."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

AZURE_PRICE_PER_CONTAINER_S = 0.0002692  # US$ (paper Fig. 9 source [8])


# --------------------------------------------------------------------------
# The two per-round timeline metrics, defined ONCE for all three execution
# vehicles (simulation RoundEngine, multi-job JITScheduler, real-training
# FLJobRuntime replay). §6.2 reports aggregation latency; §5.5 tracks how
# late a round completed against the predicted round end (the SLA the JIT
# timer defends).
# --------------------------------------------------------------------------
def aggregation_latency(completion_t: float, last_arrival_t: float) -> float:
    """§6.2 aggregation latency: completion − last update arrival."""
    return completion_t - last_arrival_t


def sla_lateness(completion_t: float, round_start_t: float,
                 t_rnd_pred: float) -> float:
    """§5.5 SLA lateness: completion − predicted round end
    (round_start + t_rnd). Negative values mean the round beat the SLA."""
    return completion_t - (round_start_t + t_rnd_pred)


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (the one definition for per-job p95 and the
    fleet rollup); 0.0 on an empty sample."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def percentile(xs: List[float], q: float) -> float:
    """Public nearest-rank percentile — the definition every rollup
    (per-job, batch fleet, windowed online) shares, so their percentiles
    reconcile bit-for-bit on identical sample multisets."""
    return _percentile(xs, q)


def pooled_round_samples(
    jobs: Dict[str, "JobMetrics"],
) -> Tuple[List[float], List[float]]:
    """Pool per-round (§6.2 latency, §5.5 lateness) samples across jobs in
    job-insertion order — the one pooling ``fleet_rollup`` and the online
    ``WindowedFleetMetrics`` end-of-run reconciliation both use."""
    latencies = [x for m in jobs.values() for x in m.round_latencies]
    lateness = [x for m in jobs.values() for x in m.round_lateness]
    return latencies, lateness


@dataclasses.dataclass
class JobMetrics:
    job_id: str
    strategy: str
    round_latencies: List[float] = dataclasses.field(default_factory=list)
    rounds_done: int = 0
    updates_received: int = 0
    container_seconds: float = 0.0
    cost_usd: float = 0.0
    n_deploys: int = 0
    jit_deploys: int = 0
    jit_early_drains: int = 0
    dropped_updates: int = 0  # parties that missed the t_wait window (§4.3)
    quorum_failures: int = 0  # rounds below quorum (§5.1)
    finished_at: Optional[float] = None
    predictions: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list
    )  # (t_rnd, t_agg) per round, JIT only
    round_lateness: List[float] = dataclasses.field(
        default_factory=list
    )  # completion − predicted round end, scheduler vehicle only (§5.5)

    @property
    def mean_latency(self) -> float:
        return statistics.fmean(self.round_latencies) if self.round_latencies else 0.0

    @property
    def p95_latency(self) -> float:
        return _percentile(self.round_latencies, 0.95)

    def summary(self) -> Dict[str, float]:
        return {
            "strategy": self.strategy,
            "rounds": self.rounds_done,
            "mean_latency_s": round(self.mean_latency, 3),
            "p95_latency_s": round(self.p95_latency, 3),
            "container_seconds": round(self.container_seconds, 1),
            "cost_usd": round(self.container_seconds * AZURE_PRICE_PER_CONTAINER_S, 4),
            "job_duration_s": round(self.finished_at or 0.0, 1),
        }


def savings(base: JobMetrics, ours: JobMetrics) -> float:
    """Resource-saving percentage of `ours` relative to `base` (paper Fig. 9)."""
    if base.container_seconds <= 0:
        return 0.0
    return 100.0 * (1.0 - ours.container_seconds / base.container_seconds)


# --------------------------------------------------------------------------
# fleet-level rollup (repro.fleet): the Fig. 9 headline is a FLEET number —
# many concurrent jobs contending for one aggregation cluster — so the
# per-job §6.2 metrics aggregate into one cross-job summary.
# --------------------------------------------------------------------------
def utilization_timeline(
    occupancy_events: List[Tuple[float, int]],
    capacity: int,
    makespan_s: float,
    n_bins: int = 50,
) -> List[Tuple[float, float]]:
    """Bin ``Cluster.occupancy_events`` (t, ±1 container deltas) into
    ``(bin_end_s, mean fraction of capacity occupied)`` samples."""
    if makespan_s <= 0.0 or capacity <= 0 or n_bins <= 0:
        return []
    width = makespan_s / n_bins
    busy = [0.0] * n_bins  # container-seconds per bin
    level = 0
    prev_t = 0.0
    events = sorted(occupancy_events) + [(makespan_s, 0)]
    for t, delta in events:
        t = min(max(t, 0.0), makespan_s)
        if t > prev_t and level > 0:
            lo, hi = prev_t, t
            first, last = int(lo / width), min(int(hi / width), n_bins - 1)
            for b in range(first, last + 1):
                overlap = min(hi, (b + 1) * width) - max(lo, b * width)
                if overlap > 0:
                    busy[b] += level * overlap
        prev_t = max(prev_t, t)
        level += delta
    return [
        (round((b + 1) * width, 6), busy[b] / (capacity * width))
        for b in range(n_bins)
    ]


@dataclasses.dataclass
class FleetMetrics:
    """Cross-job rollup of one fleet run (see ``repro.fleet.FleetRunner``)."""

    n_jobs: int
    rounds_done: int
    makespan_s: float
    container_seconds: float
    cost_usd: float
    p50_latency_s: float  # §6.2 aggregation latency, pooled over all rounds
    p95_latency_s: float
    p50_lateness_s: float  # §5.5 SLA lateness, pooled over all rounds
    p95_lateness_s: float
    n_preemptions: int
    n_deploys: int
    quorum_failures: int
    # container-seconds / (capacity * makespan); exceeds 1.0 when dedicated
    # always-on containers (outside the pooled capacity) outnumber the pool
    # — i.e. the eager-AO fleet needs a bigger cluster than it was given
    utilization: float
    # (bin_end_s, fraction of cluster capacity occupied) samples
    utilization_timeline: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)

    def summary(self) -> Dict[str, float]:
        return {
            "n_jobs": self.n_jobs,
            "rounds": self.rounds_done,
            "makespan_s": round(self.makespan_s, 1),
            "container_seconds": round(self.container_seconds, 1),
            "cost_usd": round(self.cost_usd, 4),
            "p50_latency_s": round(self.p50_latency_s, 3),
            "p95_latency_s": round(self.p95_latency_s, 3),
            "p50_lateness_s": round(self.p50_lateness_s, 3),
            "p95_lateness_s": round(self.p95_lateness_s, 3),
            "preemptions": self.n_preemptions,
            "deploys": self.n_deploys,
            "quorum_failures": self.quorum_failures,
            "utilization": round(self.utilization, 4),
        }


def fleet_rollup(
    jobs: Dict[str, JobMetrics],
    *,
    capacity: int,
    makespan_s: float,
    n_preemptions: int = 0,
    occupancy_events: Optional[List[Tuple[float, int]]] = None,
    price_per_container_s: float = AZURE_PRICE_PER_CONTAINER_S,
    timeline_bins: int = 50,
) -> FleetMetrics:
    """Aggregate per-job §6.2 metrics into one fleet-level summary."""
    latencies, lateness = pooled_round_samples(jobs)
    cs = sum(m.container_seconds for m in jobs.values())
    denom = capacity * makespan_s
    return FleetMetrics(
        n_jobs=len(jobs),
        rounds_done=sum(m.rounds_done for m in jobs.values()),
        makespan_s=makespan_s,
        container_seconds=cs,
        cost_usd=cs * price_per_container_s,
        p50_latency_s=_percentile(latencies, 0.50),
        p95_latency_s=_percentile(latencies, 0.95),
        p50_lateness_s=_percentile(lateness, 0.50),
        p95_lateness_s=_percentile(lateness, 0.95),
        n_preemptions=n_preemptions,
        n_deploys=sum(m.n_deploys for m in jobs.values()),
        quorum_failures=sum(m.quorum_failures for m in jobs.values()),
        utilization=cs / denom if denom > 0 else 0.0,
        utilization_timeline=utilization_timeline(
            occupancy_events or [], capacity, makespan_s, timeline_bins),
    )
