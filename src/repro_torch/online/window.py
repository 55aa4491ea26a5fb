"""Tumbling-window streaming metrics for the online control plane.

Batch fleet runs roll every per-round sample into one ``fleet_rollup`` at
the end; a long-lived service needs numbers *while it runs*. A
``WindowedFleetMetrics`` cuts the virtual timeline into fixed tumbling
windows and accumulates, per window: completed rounds, §6.2 aggregation
latency samples, §5.5 SLA lateness (overall and per SLA class), §5.5
preemptions per SLA class, container-seconds recognised in the window,
admission outcomes (admitted/queued/shed) and the aggregator-pool size at
the window close.

``snapshot()`` is pollable mid-run and returns only *completed* (finalised)
windows — their stats never change afterwards, so a mid-run poll agrees
exactly with the end-of-run view of the same windows. ``rollup()`` after
``close()`` reconciles against the batch ``fleet_rollup`` on closed
traces: identical pooled sample multisets through the same nearest-rank
``percentile``, and container-seconds read through the same per-job
cluster ledger — bit-for-bit (locked in ``tests/test_online.py``).

Edge semantics (regression-locked):
  * an empty window reports ``p50_latency_s is None`` — never a fake 0.0
    sample that would pool into percentiles as "instant";
  * the final window is clamped to the sim horizon at ``close(horizon)``
    (a partial window, ``end_s <= start_s + window_s``);
  * a single-sample window has finite p95 == its one sample.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.events import EventHandle, Simulator
from repro_torch.core.metrics import percentile


@dataclasses.dataclass
class WindowStats:
    """One tumbling window's accumulated service metrics."""

    index: int
    start_s: float
    end_s: float  # clamped to the sim horizon on the final partial window
    n_rounds: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
    lateness: List[float] = dataclasses.field(default_factory=list)
    lateness_by_class: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    #: §5.5 preemptions recognised in this window, attributed to the
    #: preempted job's SLA class — under class-rank scheduling this shows
    #: best_effort absorbing the evictions that protect gold mid-run
    preemptions_by_class: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    container_seconds: float = 0.0  # billing recognised in this window
    pool_capacity_end: int = 0  # aggregator-pool size at window close
    n_admitted: int = 0
    n_queued: int = 0
    n_shed: int = 0

    def _pct(self, xs: List[float], q: float) -> Optional[float]:
        # None on an empty window: no samples means no percentile, not 0.0
        return percentile(xs, q) if xs else None

    @property
    def p50_latency_s(self) -> Optional[float]:
        return self._pct(self.latencies, 0.50)

    @property
    def p95_latency_s(self) -> Optional[float]:
        return self._pct(self.latencies, 0.95)

    @property
    def p95_lateness_s(self) -> Optional[float]:
        return self._pct(self.lateness, 0.95)

    def class_p95_lateness_s(self, name: str) -> Optional[float]:
        return self._pct(self.lateness_by_class.get(name, []), 0.95)

    def summary(self) -> Dict[str, object]:
        return {
            "window": self.index,
            "start_s": round(self.start_s, 3),
            "end_s": round(self.end_s, 3),
            "rounds": self.n_rounds,
            "p50_latency_s": (None if self.p50_latency_s is None
                              else round(self.p50_latency_s, 3)),
            "p95_latency_s": (None if self.p95_latency_s is None
                              else round(self.p95_latency_s, 3)),
            "p95_lateness_s": (None if self.p95_lateness_s is None
                               else round(self.p95_lateness_s, 3)),
            "container_seconds": round(self.container_seconds, 3),
            "pool_capacity": self.pool_capacity_end,
            "admitted": self.n_admitted,
            "queued": self.n_queued,
            "shed": self.n_shed,
            "p95_lateness_by_class_s": {
                name: (None if self.class_p95_lateness_s(name) is None
                       else round(self.class_p95_lateness_s(name), 3))
                for name in sorted(self.lateness_by_class)},
            "preemptions_by_class": dict(sorted(
                self.preemptions_by_class.items())),
        }

    def _frozen_copy(self) -> "WindowStats":
        return dataclasses.replace(
            self,
            latencies=list(self.latencies),
            lateness=list(self.lateness),
            lateness_by_class={k: list(v)
                               for k, v in self.lateness_by_class.items()},
            preemptions_by_class=dict(self.preemptions_by_class),
        )


class WindowedFleetMetrics:
    """Tumbling-window metrics over one online service's timeline.

    ``cs_getter`` returns the *cumulative* container-seconds billed so far
    to the service's jobs (read from the cluster's per-job ledger in job
    insertion order — the exact sum ``fleet_rollup`` computes, which is
    what makes the end-of-run reconciliation bit-for-bit); per-window
    billing is the delta across the window. ``pool_getter`` returns the
    current aggregator-pool capacity.
    """

    def __init__(
        self,
        sim: Simulator,
        window_s: float,
        *,
        cs_getter: Callable[[], float],
        pool_getter: Callable[[], int],
        price_per_container_s: float,
        preempt_getter: Optional[Callable[[], Dict[str, int]]] = None,
    ):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.sim = sim
        self.window_s = window_s
        self._cs_getter = cs_getter
        self._pool_getter = pool_getter
        # cumulative per-class §5.5 preemption counts (optional); per-window
        # numbers are the delta across the window, like container_seconds
        self._preempt_getter = preempt_getter
        self._preempt_at_cur_start: Dict[str, int] = {}
        self.price = price_per_container_s
        self._completed: List[WindowStats] = []
        self._cur = WindowStats(index=0, start_s=0.0, end_s=window_s)
        self._cs_at_cur_start = 0.0
        self._boundary: Optional[EventHandle] = None
        self._closed = False
        self._horizon_s: Optional[float] = None
        self._cs_total: Optional[float] = None

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        """Arm the first window-boundary event (idempotent)."""
        if self._boundary is None and not self._closed:
            self._boundary = self.sim.schedule_at(
                self._cur.end_s, self._on_boundary)

    def _on_boundary(self) -> None:
        self._boundary = None
        self._finalize(self._cur.end_s)
        self._boundary = self.sim.schedule_at(
            self._cur.end_s, self._on_boundary)

    def _finalize(self, end_s: float) -> None:
        cur = self._cur
        cur.end_s = end_s
        cs = self._cs_getter()
        cur.container_seconds = cs - self._cs_at_cur_start
        cur.pool_capacity_end = self._pool_getter()
        if self._preempt_getter is not None:
            tot = self._preempt_getter()
            prev = self._preempt_at_cur_start
            cur.preemptions_by_class = {
                name: n - prev.get(name, 0)
                for name, n in tot.items() if n - prev.get(name, 0)}
            self._preempt_at_cur_start = dict(tot)
        self._completed.append(cur)
        self._cs_at_cur_start = cs
        self._cur = WindowStats(
            index=cur.index + 1, start_s=end_s,
            end_s=end_s + self.window_s)

    def close(self, horizon_s: Optional[float] = None) -> None:
        """End of service: cancel the boundary timer and finalise the
        current window, clamped to the sim horizon (never padded out to a
        full ``window_s`` past the last event). A zero-width residue (the
        horizon landing exactly on a boundary) is dropped, not emitted as
        an empty window."""
        if self._closed:
            return
        self._closed = True
        if self._boundary is not None:
            self._boundary.cancel()
            self._boundary = None
        horizon = self.sim.now if horizon_s is None else horizon_s
        self._cs_total = self._cs_getter()
        end = min(max(horizon, self._cur.start_s), self._cur.end_s)
        if end > self._cur.start_s:
            self._finalize(end)
        self._horizon_s = horizon

    @property
    def closed(self) -> bool:
        return self._closed

    # ---- observations (fed by the controller) ---------------------------
    def observe_round(self, sla_class: str, latencies: List[float],
                      lateness: List[float]) -> None:
        """One completed round's fresh samples (possibly empty: a round
        that closed with zero arrivals has neither)."""
        cur = self._cur
        cur.n_rounds += 1
        cur.latencies.extend(latencies)
        cur.lateness.extend(lateness)
        if lateness:
            cur.lateness_by_class.setdefault(
                sla_class, []).extend(lateness)

    def observe_admission(self, outcome: str) -> None:
        if outcome == "admitted":
            self._cur.n_admitted += 1
        elif outcome == "queued":
            self._cur.n_queued += 1
        elif outcome == "shed":
            self._cur.n_shed += 1
        else:
            raise ValueError(f"unknown admission outcome {outcome!r}")

    # ---- reads -----------------------------------------------------------
    def snapshot(self) -> List[WindowStats]:
        """Completed windows so far (frozen copies, pollable mid-run). A
        window appears here only once its boundary passed, and its stats
        never change afterwards — a mid-run poll is a prefix of the
        end-of-run snapshot, value-identical on shared windows."""
        return [w._frozen_copy() for w in self._completed]

    def rollup(self) -> Dict[str, object]:
        """End-of-run rollup over every completed window. On a closed
        trace this reconciles bit-for-bit with the batch ``fleet_rollup``:
        same pooled sample multisets, same nearest-rank ``percentile``,
        and container-seconds read from the same per-job cluster ledger
        (the cumulative ``cs_getter`` at close, not a float re-sum of the
        per-window deltas)."""
        if not self._closed:
            raise RuntimeError(
                "rollup() is the end-of-run reconciliation; call close() "
                "first (poll snapshot() mid-run)")
        latencies = [x for w in self._completed for x in w.latencies]
        lateness = [x for w in self._completed for x in w.lateness]
        cs = self._cs_total if self._cs_total is not None else 0.0
        by_class: Dict[str, List[float]] = {}
        for w in self._completed:
            for name, xs in w.lateness_by_class.items():
                by_class.setdefault(name, []).extend(xs)
        preempt: Dict[str, int] = {}
        for w in self._completed:
            for name, n in w.preemptions_by_class.items():
                preempt[name] = preempt.get(name, 0) + n
        return {
            "windows": len(self._completed),
            "window_s": self.window_s,
            "makespan_s": self._horizon_s,
            "rounds_done": sum(w.n_rounds for w in self._completed),
            "p50_latency_s": percentile(latencies, 0.50),
            "p95_latency_s": percentile(latencies, 0.95),
            "p50_lateness_s": percentile(lateness, 0.50),
            "p95_lateness_s": percentile(lateness, 0.95),
            "p95_lateness_by_class_s": {
                name: percentile(xs, 0.95)
                for name, xs in sorted(by_class.items())},
            "preemptions_by_class": dict(sorted(preempt.items())),
            "container_seconds": cs,
            "cost_usd": cs * self.price,
            "admitted": sum(w.n_admitted for w in self._completed),
            "queued": sum(w.n_queued for w in self._completed),
            "shed": sum(w.n_shed for w in self._completed),
        }
