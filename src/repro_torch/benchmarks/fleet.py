"""Fleet-scale savings (the paper's Fig. 9 headline, beyond-paper scope):
K concurrent FL jobs with per-job simulated parties contending for one
aggregation cluster, swept over concurrent-job count x availability
pattern for JIT (arrival-gated Fig. 6 scheduler) vs eager-AO vs eager-λ.

Every strategy prices the SAME per-party arrival sequences (paired RNG
streams, see repro_torch.fleet.parties), so savings_vs_ao_pct is a paired
comparison, not a distribution-matched one. The paper reports 60%+
savings for JIT over always-on; the default 16-job trace reproduces it
with a wide margin (JIT <= 40% of eager-AO container-seconds is locked
by tests/test_fleet.py).

  python -m repro_torch.benchmarks.fleet [--smoke] [--out BENCH_fleet.json]

--smoke runs only the default 16-job mixed trace (the golden cell) and is
what CI runs per-commit; the emitted BENCH_fleet.json seeds the performance
trajectory (one artifact per run).

Presence parity: parties announce per-round no-shows up front (§2.2) to
BOTH vehicles — the scheduler hears ``party_no_show``, the engine
baselines ``RoundEngine.announce_no_show`` via ``FleetArrivalSource`` —
so latency/makespan columns are apples-to-apples under dropout-heavy
patterns (see the conformance harness, ``repro_torch.fleet.conformance``).

Scenario matrix: besides concurrent-job count x pattern, the sweep
stresses capacity (tiny 2-container clusters -> preemption-heavy traces)
and horizon (long diurnal traces spanning many availability periods).
NB the utilization column is container-seconds / (pool capacity x
makespan) and deliberately EXCEEDS 1.0 for always-on rows on the tiny
tier: dedicated AO containers live outside the pooled capacity, so
>100% reads "this fleet demands more containers than the pool has"
(see core.metrics.FleetMetrics).
``--full`` runs the whole matrix; the default grid samples it; ``--smoke``
(CI per-commit) runs the golden 16-job cell plus one tiny-cluster stress cell.

CSV: strategy,n_jobs,pattern,capacity,horizon_rounds,rounds,makespan_s,
     container_seconds,cost_usd,p50_latency_s,p95_latency_s,
     p50_lateness_s,p95_lateness_s,preemptions,deploys,utilization,
     savings_vs_ao_pct
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.api import Platform
from repro_torch.core import AggregationEstimator, ClusterConfig
from repro_torch.fleet import synthetic_fleet
from repro_torch.fleet.conformance import CAPACITY_TIERS, TIER_T_PAIR_S

STRATEGIES: Tuple[str, ...] = ("jit", "eager_ao", "eager_serverless")
PATTERNS_SWEPT: Tuple[str, ...] = ("mixed", "steady", "intermittent",
                                   "dropout")

# The capacity tiers are DEFINED by the conformance harness (the matrix
# that defends them) and imported here so the benchmark rows can never
# drift from the cells the harness checks. The stress tier models an
# UNDER-PROVISIONED pool: few containers AND slow fuse cores
# (multi-second drains), so aggregation tasks actually contend, queue
# behind each other and get preempted by earlier-deadline drains. With
# the default t_pair the pool never binds — drains are shorter than the
# scheduling tick, so capacity 2 behaves like capacity 8.
DEFAULT_CAPACITY = CAPACITY_TIERS["default"]
TINY_CAPACITY = CAPACITY_TIERS["tiny"]
STRESS_T_PAIR_S = TIER_T_PAIR_S["tiny"]
LONG_HORIZON_ROUNDS = 24  # long-horizon (multi-day diurnal) traces

HEADER = ("strategy,n_jobs,pattern,capacity,horizon_rounds,rounds,"
          "makespan_s,container_seconds,cost_usd,p50_latency_s,"
          "p95_latency_s,p50_lateness_s,p95_lateness_s,preemptions,"
          "deploys,utilization,savings_vs_ao_pct")


def simulate(n_jobs: int, pattern: str, strategy: str, *, seed: int = 0,
             capacity: Optional[int] = None,
             horizon_rounds: Optional[int] = None,
             t_pair_s: float = 0.05, cost_table=None, tracer=None) -> Dict:
    trace = synthetic_fleet(n_jobs, pattern, seed=seed,
                            cluster_capacity=capacity,
                            horizon_rounds=horizon_rounds)
    capacity = trace.cluster_capacity or DEFAULT_CAPACITY
    platform = Platform(
        ClusterConfig(capacity=capacity),
        AggregationEstimator(t_pair_s=t_pair_s),
        cost_table=cost_table,
        tracer=tracer,
    )
    runner = platform.submit_fleet(trace, strategy=strategy)
    platform.run()
    assert runner.all_done, (strategy, n_jobs, pattern)
    if tracer is not None:
        mismatches = tracer.reconcile(platform.cluster)
        if mismatches:
            raise SystemExit(
                "trace/billing reconciliation FAILED for "
                f"{strategy}/{n_jobs}/{pattern}: " + "; ".join(mismatches))
    fleet = runner.result().fleet
    return {
        "strategy": strategy,
        "n_jobs": n_jobs,
        "pattern": pattern,
        "capacity": capacity,
        "horizon_rounds": horizon_rounds or 0,
        "rounds": fleet.rounds_done,
        "makespan_s": round(fleet.makespan_s, 1),
        "container_seconds": round(fleet.container_seconds, 1),
        "cost_usd": round(fleet.cost_usd, 4),
        "p50_latency_s": round(fleet.p50_latency_s, 3),
        "p95_latency_s": round(fleet.p95_latency_s, 3),
        "p50_lateness_s": round(fleet.p50_lateness_s, 3),
        "p95_lateness_s": round(fleet.p95_lateness_s, 3),
        "preemptions": fleet.n_preemptions,
        "deploys": fleet.n_deploys,
        "utilization": round(fleet.utilization, 4),
    }


def grid_cells(smoke: bool = False, full: bool = False
               ) -> List[Tuple[int, str, Optional[int], Optional[int]]]:
    """(n_jobs, pattern, capacity, horizon_rounds) sweep cells."""
    if smoke:
        # the golden default cell + one tiny-cluster capacity-stress sample
        return [(16, "mixed", None, None),
                (8, "dropout", TINY_CAPACITY, None)]
    counts = [4, 16] + ([32, 64] if full else [32])
    grid = [(n, p, None, None) for n in counts for p in PATTERNS_SWEPT]
    # capacity-stress tier: the same mixes on a tiny 2-container pool
    stress = PATTERNS_SWEPT if full else ("mixed", "dropout")
    grid += [(8, p, TINY_CAPACITY, None) for p in stress]
    if full:
        # long-horizon diurnal traces (many availability periods per party)
        grid += [(8, "diurnal", None, LONG_HORIZON_ROUNDS),
                 (8, "diurnal", TINY_CAPACITY, LONG_HORIZON_ROUNDS)]
    return grid


def run(smoke: bool = False, full: bool = False,
        cost_table=None) -> List[Dict]:
    """The sweep grid; --smoke keeps the CI cells (see ``grid_cells``).

    ``cost_table``: a measured `repro_torch.kernels.autotune.KernelCostTable`;
    when given, every strategy prices fuse work from autotuned kernel
    timings instead of the tier t_pair constants (the default-constants
    rows are the golden-locked ones)."""
    rows: List[Dict] = []
    for n_jobs, pattern, capacity, horizon in grid_cells(smoke, full):
        t_pair = (STRESS_T_PAIR_S if capacity == TINY_CAPACITY
                  else TIER_T_PAIR_S["default"])
        cell = {
            s: simulate(n_jobs, pattern, s, capacity=capacity,
                        horizon_rounds=horizon, t_pair_s=t_pair,
                        cost_table=cost_table)
            for s in STRATEGIES
        }
        ao_cs = cell["eager_ao"]["container_seconds"]
        for s in STRATEGIES:
            row = cell[s]
            row["savings_vs_ao_pct"] = round(
                100.0 * (1.0 - row["container_seconds"] / ao_cs), 2
            ) if ao_cs > 0 else 0.0
            rows.append(row)
            print(",".join(str(v) for v in row.values()), flush=True)
    return rows


def export_trace_artifact(path: str) -> int:
    """Re-run the golden 16-job mixed jit cell with tracing on, reconcile
    the trace against the billed ledger, and export a Perfetto-loadable
    chrome trace. Returns the number of chrome events written."""
    from repro_torch.obs import Tracer

    tracer = Tracer()
    simulate(16, "mixed", "jit", tracer=tracer)
    return tracer.export_chrome(path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI per-commit cells: the golden 16-job mixed trace "
                         "plus one tiny-cluster capacity-stress sample")
    ap.add_argument("--full", action="store_true",
                    help="full matrix: 64-job rows, capacity-stress on all "
                         "patterns, long-horizon diurnal traces (slower)")
    ap.add_argument("--out", default="BENCH_fleet.json",
                    help="write rows as JSON here ('' to skip)")
    ap.add_argument("--trace-out", default="",
                    help="re-run the golden 16-job mixed jit cell traced "
                         "and write a Perfetto-loadable chrome trace here")
    ap.add_argument("--cost-table", default="",
                    help="KernelCostTable JSON (kernel_bench "
                         "--emit-cost-table): price fuse work from measured "
                         "kernel timings instead of t_pair constants")
    args = ap.parse_args()
    cost_table = None
    if args.cost_table:
        from repro_torch.kernels.autotune import KernelCostTable

        cost_table = KernelCostTable.load(args.cost_table)
    print(HEADER)
    rows = run(smoke=args.smoke, full=args.full, cost_table=cost_table)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "fleet", "smoke": args.smoke, "rows": rows},
                      f, indent=1)
        print(f"[wrote {args.out}: {len(rows)} rows]")
    if args.trace_out:
        n = export_trace_artifact(args.trace_out)
        print(f"[wrote {args.trace_out}: {n} trace events, reconciled]")


if __name__ == "__main__":
    main()
