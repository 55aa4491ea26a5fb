"""Online control plane under burst traffic (beyond-paper scope): the
Platform as a long-lived service (``Platform.serve``) consuming an
open-loop Poisson/diurnal arrival stream whose job rate jumps to 3x
steady-state for one diurnal period — the scenario the ROADMAP's
"streaming control plane" item names as the prerequisite for any
millions-of-users deployment.

Three variants consume the IDENTICAL arrival stream (same seed, same
re-timed job sequence; admission decisions are rate-based only, so the
admitted job multiset pairs up exactly):

  jit-autoscaled   Fig. 6 arrival-gated JIT scheduler; the aggregator pool
                   autoscales against queue depth + drain backlog with
                   hysteresis (AutoscalerConfig), between min_capacity and
                   max_capacity.
  jit-fixed        the same scheduler on a statically provisioned pool
                   (AutoscalerConfig.fixed) sized for the burst peak.
  eager_ao-fixed   the always-on baseline (one dedicated aggregator
                   container per job, alive from round 0) on the same
                   fixed pool.

Jobs cycle through the gold/silver/best_effort SLA ladder by arrival
index: under the burst, gold still admits immediately, silver queues, and
best_effort is shed (per-class §5.5 lateness accounted by the
controller). Two headline columns, both golden-locked in
tests/test_online.py:

  savings_vs_ao_pct       billed container-seconds vs the eager-AO
                          variant (the paper's Fig. 9 comparison, now
                          under open-loop burst traffic)
  pool_savings_vs_fixed_pct  the autoscaled pool's provisioned
                          container-seconds (integral of capacity over the
                          service lifetime) vs the burst-peak-sized fixed
                          pool — what autoscaling saves in RESERVED
                          capacity even before per-task billing

A second golden cell, ``saturation``, removes admission relief entirely
(nothing queues or sheds) and caps the pool well below demand: the only
protection left is §5.5 class-rank pool scheduling. ``jit-classed``
holds gold inside its 60s band while silver/best_effort absorb the
preemptions; ``jit-classless`` (identical stream, every rank zeroed)
shows gold blowing the band without priorities.

  python -m repro_torch.benchmarks.online [--smoke] [--full] [--out BENCH_online.json]
                              [--classes-out report.json]

--smoke is the CI per-commit tier (the burst cell + the saturation cell,
seconds of wall-clock); --full adds the long scenario (repeated trace
cycles, two diurnal periods of burst) that the nightly tier runs.
--classes-out writes the per-class lateness/preemption report the
nightly conformance job uploads as an artifact.

CSV: variant,strategy,scenario,arrived,admitted,queued,shed,rounds,
     makespan_s,container_seconds,cost_usd,pool_container_seconds,
     peak_pool,scale_ups,scale_downs,p50_latency_s,p95_latency_s,
     gold_p95_lateness_s,gold_band_s,gold_attained,silver_p95_lateness_s,
     best_effort_shed,gold_preemptions,silver_preemptions,
     best_effort_preemptions,windows,savings_vs_ao_pct,
     pool_savings_vs_fixed_pct
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.api import Platform
from repro_torch.core import AggregationEstimator, ClusterConfig
from repro_torch.fleet import synthetic_fleet
from repro_torch.online import (
    SLA_CLASSES,
    AdmissionConfig,
    AutoscalerConfig,
    TraceStream,
)

#: gold/silver/best_effort by arrival index — identical across variants
#: because the stream (and therefore the index order) is identical
SLA_CYCLE: Tuple[str, ...] = ("gold", "silver", "best_effort")

#: the statically provisioned pool the fixed variants run on, sized for
#: the burst peak (the default fleet tier capacity)
FIXED_POOL = 8

#: stress fuse time (the conformance tiny-tier value): multi-second
#: drains make pool pressure real, so the autoscaler has work to do
STRESS_T_PAIR_S = 2.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One open-loop scenario (everything seeded/deterministic)."""

    name: str
    n_jobs: int = 18
    pattern: str = "mixed"
    seed: int = 0
    repeat: int = 1
    mean_interarrival_s: float = 120.0
    diurnal_period_s: float = 2400.0
    diurnal_amplitude: float = 0.3
    #: (start_s, len_s, factor): rate x3 for one diurnal period; None for
    #: a sustained (burst-free) stream
    burst: Optional[Tuple[float, float, float]] = (800.0, 2400.0, 3.0)
    window_s: float = 600.0
    t_pair_s: float = STRESS_T_PAIR_S
    #: front-door admission knobs; the saturation cell sets burst_arrivals
    #: beyond the arrival count so NOTHING queues or sheds — class-aware
    #: pool priorities must do all the protecting
    burst_window_s: float = 300.0
    burst_arrivals: int = 4
    #: pool caps for the autoscaled variants (fixed variants provision
    #: max_capacity, the burst-peak size)
    min_capacity: int = 1
    max_capacity: int = FIXED_POOL
    #: declared §5.5 lateness bands for this scenario. The default
    #: ladder's 60s gold band assumes calibrated steady fleets; the burst
    #: scenarios run stress fuse times (t_pair 2s) over parties whose
    #: declared train times miss the truth by up to 40%, so rounds
    #: overrun their deadlines by minutes regardless of admission class —
    #: their bands are the deterministic observed p95 with ~1.5x
    #: headroom, golden-locked in tests/test_online.py.
    gold_band_s: float = 240.0
    silver_band_s: float = 900.0

    def stream(self) -> TraceStream:
        trace = synthetic_fleet(self.n_jobs, self.pattern, seed=self.seed)
        return TraceStream(
            trace, timing="poisson",
            mean_interarrival_s=self.mean_interarrival_s,
            diurnal_period_s=self.diurnal_period_s,
            diurnal_amplitude=self.diurnal_amplitude,
            burst=self.burst, seed=self.seed, repeat=self.repeat,
        )

    def sla_classes(self, classless: bool = False) -> Dict:
        """This scenario's ladder. ``classless`` zeroes every rank and
        weight (pure-deadline pool scheduling, the pre-priorities
        behavior) while keeping the admission flags identical, so the
        classed/classless comparison stays paired at the front door."""
        ladder = {
            "gold": dataclasses.replace(
                SLA_CLASSES["gold"], lateness_p95_band_s=self.gold_band_s),
            "silver": dataclasses.replace(
                SLA_CLASSES["silver"],
                lateness_p95_band_s=self.silver_band_s),
            "best_effort": SLA_CLASSES["best_effort"],
        }
        if classless:
            ladder = {n: dataclasses.replace(c, rank=0, backlog_weight=1.0)
                      for n, c in ladder.items()}
        return ladder


SMOKE = Scenario(name="burst-3x")
#: The nightly cell: repeated trace cycles under two diurnal periods of
#: 3x burst, heavy drains (t_pair 6s) on a pool capped well below burst
#: demand — the sustained-overload regime where admission control alone
#: cannot protect gold. Class-rank pool priorities hold gold near its
#: calibration floor (~455s of declared-train-time error intrinsic to
#: the mixed pattern — no scheduling policy can remove it, hence the
#: 700s band) while the same stream with ranks zeroed melts down to a
#: gold p95 in the hours (guarded in tests/test_online.py slow tier).
LONG = Scenario(name="burst-3x-long", n_jobs=16, repeat=3, seed=1,
                mean_interarrival_s=90.0, diurnal_period_s=3600.0,
                burst=(1200.0, 7200.0, 3.0), t_pair_s=6.0,
                max_capacity=3, gold_band_s=700.0)
#: Pool saturation without admission relief: a sustained high-rate stream
#: (no burst window — burst_arrivals is set beyond the arrival count, so
#: every job admits immediately and nothing queues or sheds) onto a pool
#: capped well below demand. The ONLY thing separating the classes is
#: §5.5 class-rank pool scheduling: gold drains jump the queue and
#: preempt running best_effort drains. The jit-classless variant runs the
#: identical stream with every rank zeroed — gold then waits like
#: everyone else and blows its 60s band (both outcomes golden-locked in
#: tests/test_online.py).
SATURATION = Scenario(name="saturation", n_jobs=24, pattern="steady",
                      seed=0, mean_interarrival_s=25.0,
                      diurnal_amplitude=0.0, burst=None, t_pair_s=6.0,
                      burst_arrivals=10_000, min_capacity=1,
                      max_capacity=2, gold_band_s=60.0,
                      silver_band_s=math.inf)

VARIANTS: Tuple[Tuple[str, str, bool], ...] = (
    # (variant, strategy, autoscaled)
    ("jit-autoscaled", "jit", True),
    ("jit-fixed", "jit", False),
    ("eager_ao-fixed", "eager_ao", False),
)

#: the saturation cell's variants: classed vs classless JIT under the
#: identical stream, plus the always-on baseline for the savings floor
SATURATION_VARIANTS: Tuple[Tuple[str, str, bool, bool], ...] = (
    # (variant, strategy, autoscaled, classless)
    ("jit-classed", "jit", True, False),
    ("jit-classless", "jit", True, True),
    ("eager_ao-fixed", "eager_ao", False, False),
)

HEADER = ("variant,strategy,scenario,arrived,admitted,queued,shed,rounds,"
          "makespan_s,container_seconds,cost_usd,pool_container_seconds,"
          "peak_pool,scale_ups,scale_downs,p50_latency_s,p95_latency_s,"
          "gold_p95_lateness_s,gold_band_s,gold_attained,"
          "silver_p95_lateness_s,best_effort_shed,gold_preemptions,"
          "silver_preemptions,best_effort_preemptions,windows,"
          "savings_vs_ao_pct,pool_savings_vs_fixed_pct")


def assign_sla(jt, idx: int) -> str:
    return SLA_CYCLE[idx % len(SLA_CYCLE)]


def serve_variant(scenario: Scenario, variant: str, strategy: str,
                  autoscaled: bool, classless: bool = False,
                  trace=None) -> Dict:
    """Run one variant of the scenario to quiescence. ``trace`` (a
    ``repro_torch.obs.Tracer``) records the run; traced container-seconds are
    reconciled against the billed ledger before returning."""
    platform = Platform(
        ClusterConfig(capacity=2 if autoscaled else scenario.max_capacity),
        AggregationEstimator(t_pair_s=scenario.t_pair_s),
    )
    auto = (AutoscalerConfig(min_capacity=scenario.min_capacity,
                             max_capacity=scenario.max_capacity)
            if autoscaled else AutoscalerConfig.fixed(scenario.max_capacity))
    ladder = scenario.sla_classes(classless)
    svc = platform.serve(
        scenario.stream(), strategy=strategy, sla=assign_sla,
        sla_classes=ladder, autoscaler=auto,
        admission=AdmissionConfig(burst_window_s=scenario.burst_window_s,
                                  burst_arrivals=scenario.burst_arrivals),
        window_s=scenario.window_s,
        trace=trace,
    )
    report = svc.drain()
    if trace is not None:
        mismatches = trace.reconcile(platform.cluster)
        if mismatches:
            raise SystemExit(
                "trace/billing reconciliation FAILED for "
                f"{scenario.name}/{variant}: " + "; ".join(mismatches))
    att = report.sla_attainment(ladder)
    classes = report.classes
    arrived = sum(st.arrived for st in classes.values())
    admitted = sum(st.admitted for st in classes.values())
    queued = sum(st.queued for st in classes.values())
    gold = att["gold"]
    return {
        "variant": variant,
        "strategy": strategy,
        "scenario": scenario.name,
        "arrived": arrived,
        "admitted": admitted,
        "queued": queued,
        "shed": len(report.shed_jobs),
        "rounds": report.fleet.rounds_done,
        "makespan_s": round(report.fleet.makespan_s, 1),
        "container_seconds": round(report.fleet.container_seconds, 1),
        "cost_usd": round(report.fleet.cost_usd, 4),
        "pool_container_seconds": round(report.pool_container_seconds, 1),
        "peak_pool": report.peak_pool,
        "scale_ups": svc.n_scale_ups,
        "scale_downs": svc.n_scale_downs,
        "p50_latency_s": round(report.fleet.p50_latency_s, 3),
        "p95_latency_s": round(report.fleet.p95_latency_s, 3),
        "gold_p95_lateness_s": (
            None if gold["p95_lateness_s"] is None
            else round(gold["p95_lateness_s"], 3)),
        "gold_band_s": scenario.gold_band_s,
        "gold_attained": gold["attained"],
        "silver_p95_lateness_s": (
            None if att["silver"]["p95_lateness_s"] is None
            else round(att["silver"]["p95_lateness_s"], 3)),
        "best_effort_shed": classes["best_effort"].shed,
        "gold_preemptions": classes["gold"].preemptions,
        "silver_preemptions": classes["silver"].preemptions,
        "best_effort_preemptions": classes["best_effort"].preemptions,
        "windows": len(report.windows),
    }


def run(smoke: bool = False, full: bool = False) -> List[Dict]:
    """Every cell emits rows keyed (scenario, variant). --smoke runs the
    burst cell plus the saturation cell (both seconds of wall-clock);
    --full adds the long repeated-cycle burst scenario (nightly)."""
    four = [(v, s, a, False) for v, s, a in VARIANTS]
    cells = [(SMOKE, four), (SATURATION, list(SATURATION_VARIANTS))]
    if full:
        cells.append((LONG, four))
    rows: List[Dict] = []
    for scenario, variants in cells:
        cell = {v: serve_variant(scenario, v, s, a, c)
                for v, s, a, c in variants}
        ao = cell["eager_ao-fixed"]
        fixed_pool_cs = ao["pool_container_seconds"]
        for variant, _, _, _ in variants:
            row = cell[variant]
            ao_cs = ao["container_seconds"]
            row["savings_vs_ao_pct"] = round(
                100.0 * (1.0 - row["container_seconds"] / ao_cs), 2
            ) if ao_cs > 0 else 0.0
            row["pool_savings_vs_fixed_pct"] = round(
                100.0 * (1.0 - row["pool_container_seconds"]
                         / fixed_pool_cs), 2
            ) if fixed_pool_cs > 0 else 0.0
            rows.append(row)
            print(",".join(str(v) for v in row.values()), flush=True)
    return rows


def class_report(rows: List[Dict]) -> Dict:
    """The per-class lateness/preemption report (the nightly conformance
    job uploads this as an artifact): per (scenario, variant), each
    class's p95 lateness vs band plus its preemption count."""
    out: List[Dict] = []
    for row in rows:
        out.append({
            "scenario": row["scenario"],
            "variant": row["variant"],
            "gold": {"p95_lateness_s": row["gold_p95_lateness_s"],
                     "band_s": row["gold_band_s"],
                     "attained": row["gold_attained"],
                     "preemptions": row["gold_preemptions"]},
            "silver": {"p95_lateness_s": row["silver_p95_lateness_s"],
                       "preemptions": row["silver_preemptions"]},
            "best_effort": {"shed": row["best_effort_shed"],
                            "preemptions": row["best_effort_preemptions"]},
        })
    return {"report": "per-class-lateness", "cells": out}


def export_trace_artifact(path: str, scenario: Scenario = SMOKE) -> int:
    """Re-run the jit-autoscaled variant of ``scenario`` with tracing on,
    reconcile the trace against the billed ledger, and export a
    Perfetto/chrome-trace JSON artifact. Returns the number of chrome
    events written (serve_variant raises SystemExit on mismatch)."""
    from repro_torch.obs import Tracer

    tracer = Tracer()
    serve_variant(scenario, "jit-autoscaled", "jit", True, trace=tracer)
    return tracer.export_chrome(path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI per-commit cell: the single-period burst scenario")
    ap.add_argument("--full", action="store_true",
                    help="adds the long repeated-cycle burst scenario "
                         "(nightly tier)")
    ap.add_argument("--out", default="BENCH_online.json",
                    help="write rows as JSON here ('' to skip)")
    ap.add_argument("--classes-out", default="",
                    help="also write the per-class lateness/preemption "
                         "report here (the nightly artifact)")
    ap.add_argument("--trace-out", default="",
                    help="re-run the burst jit-autoscaled cell traced and "
                         "write a Perfetto-loadable chrome trace here")
    args = ap.parse_args()
    print(HEADER)
    rows = run(smoke=args.smoke, full=args.full)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "online", "smoke": args.smoke,
                       "rows": rows}, f, indent=1)
        print(f"[wrote {args.out}: {len(rows)} rows]")
    if args.classes_out:
        with open(args.classes_out, "w") as f:
            json.dump(class_report(rows), f, indent=1)
        print(f"[wrote {args.classes_out}]")
    if args.trace_out:
        n = export_trace_artifact(args.trace_out)
        print(f"[wrote {args.trace_out}: {n} trace events, reconciled]")


if __name__ == "__main__":
    main()
