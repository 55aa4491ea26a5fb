"""Simulator-core self-benchmark (``BENCH_simcore.json``): how fast does
the fleet simulator itself run?

Every other benchmark measures the SIMULATED system (container-seconds,
latency); this one measures the simulator, so the fleet-at-scale machinery
is golden-locked like everything else. Each cell runs one synthetic
party-heavy fleet trace through the scheduler vehicle twice:

  legacy  rng="pcg64", per-event path — one sequential RNG stream and one
          simulator event per (party, round) arrival (the pre-fast-path
          behaviour, kept as the default for golden stability)
  fast    rng="philox", vectorized — per-job presampled counter-stream
          grids + analytic drain triggers (one calendar entry per round,
          ``JITScheduler.begin_round_presampled``)

Per row: arrivals simulated, simulator events executed (``Simulator.
n_processed``), wall seconds, arrivals/sec, events/sec, wall seconds per
simulated hour, and a peak-RSS proxy (``ru_maxrss``). Per cell: the
fast/legacy **speedup, measured on arrivals/sec** — the fast path
deliberately executes ~10x fewer simulator events for the same simulated
work, so raw events/sec would undercount the win (same numerator
semantics across modes: arrivals priced per wall second).

  python -m repro_torch.benchmarks.simcore [--smoke] [--full] [--check BASELINE]

--smoke runs the small cell only (CI per-commit; deterministic columns are
golden-locked in tests/test_simcore_bench.py). --full adds the 5,000-job
diurnal acceptance row (fast mode only; the ROADMAP "minutes, not hours"
target). --check compares against a committed baseline JSON: the
deterministic columns (arrivals, events) must match exactly and the
fast/legacy speedup must hold at >= 70% of the baseline's — a RATIO
guard, not an absolute events/sec floor, so it ports across CI hardware
while still failing a >30% perf regression of the fast path relative to
the very code it shares the box with.

The large cell asserts the >=10x speedup floor.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.api import Platform
from repro_torch.core import AggregationEstimator, ClusterConfig
from repro_torch.fleet.traces import JobClass, synthetic_fleet

#: (name, n_jobs, JobClass, pattern): party-heavy single-class mixes —
#: vectorization pays off per party, so cells scale parties before jobs
CELLS: Tuple[Tuple[str, int, JobClass, str], ...] = (
    ("small", 50, JobClass("p32", 32, 50 << 20, 60.0, 16, 0.5), "steady"),
    ("medium", 150, JobClass("p128", 128, 50 << 20, 60.0, 20, 0.5),
     "diurnal"),
    ("large", 100, JobClass("p256", 256, 50 << 20, 60.0, 30, 0.5),
     "diurnal"),
)

#: the acceptance floor on the large cell (fast vs legacy)
LARGE_SPEEDUP_FLOOR = 10.0
#: --check: fail if speedup falls below this fraction of the baseline's
CHECK_SPEEDUP_FRACTION = 0.7
#: trace-on wall-clock overhead ceiling on the small/fast cell
TRACE_OVERHEAD_CEILING_PCT = 10.0

MODES: Tuple[Tuple[str, str, bool], ...] = (
    ("legacy", "pcg64", False),
    ("fast", "philox", True),
)

HEADER = ("cell,mode,n_jobs,parties_per_job,rounds_per_job,arrivals,"
          "events,wall_s,arrivals_per_sec,events_per_sec,sim_hours,"
          "wall_s_per_sim_hour,peak_rss_kb")


def run_cell(name: str, n_jobs: int, jc: JobClass, pattern: str,
             mode: str, rng: str, vectorized: bool, *,
             seed: int = 0, trace_run: bool = False) -> Dict:
    trace = synthetic_fleet(n_jobs, pattern, seed=seed, job_mix=(jc,),
                            stagger_s=5.0)
    tracer = None
    if trace_run:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    platform = Platform(ClusterConfig(capacity=64),
                        AggregationEstimator(t_pair_s=0.05),
                        tracer=tracer)
    runner = platform.submit_fleet(trace, strategy="jit",
                                   rng=rng, vectorized=vectorized)
    t0 = time.perf_counter()
    platform.run()
    wall = time.perf_counter() - t0
    assert runner.all_done, (name, mode)
    arrivals = sum(m.updates_received for m in runner.metrics().values())
    sim_hours = platform.sim.now / 3600.0
    return {
        "cell": name,
        "mode": mode,
        "n_jobs": n_jobs,
        "parties_per_job": jc.n_parties,
        "rounds_per_job": jc.rounds,
        "arrivals": arrivals,
        "events": platform.sim.n_processed,
        "wall_s": round(wall, 3),
        "arrivals_per_sec": round(arrivals / wall, 1),
        "events_per_sec": round(platform.sim.n_processed / wall, 1),
        "sim_hours": round(sim_hours, 2),
        "wall_s_per_sim_hour": round(wall / max(sim_hours, 1e-9), 4),
        "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    }


def run_acceptance_row(seed: int = 0) -> Dict:
    """--full: the ROADMAP 5,000-job diurnal trace, fast mode only (the
    legacy leg would take ~20 minutes — exactly the problem)."""
    trace = synthetic_fleet(5000, "diurnal", seed=seed)
    platform = Platform(ClusterConfig(capacity=64),
                        AggregationEstimator(t_pair_s=0.05))
    runner = platform.submit_fleet(trace, strategy="jit",
                                   rng="philox", vectorized=True)
    t0 = time.perf_counter()
    platform.run()
    wall = time.perf_counter() - t0
    assert runner.all_done
    arrivals = sum(m.updates_received for m in runner.metrics().values())
    sim_hours = platform.sim.now / 3600.0
    return {
        "cell": "acceptance-5000job", "mode": "fast",
        "n_jobs": 5000, "parties_per_job": 0, "rounds_per_job": 0,
        "arrivals": arrivals, "events": platform.sim.n_processed,
        "wall_s": round(wall, 3),
        "arrivals_per_sec": round(arrivals / wall, 1),
        "events_per_sec": round(platform.sim.n_processed / wall, 1),
        "sim_hours": round(sim_hours, 2),
        "wall_s_per_sim_hour": round(wall / max(sim_hours, 1e-9), 4),
        "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    }


def speedups(rows: List[Dict]) -> Dict[str, float]:
    """Per-cell fast/legacy speedup on arrivals/sec (same work priced per
    wall second in both modes)."""
    by = {(r["cell"], r["mode"]): r for r in rows}
    out = {}
    for name, *_ in CELLS:
        a, b = by.get((name, "legacy")), by.get((name, "fast"))
        if a and b:
            out[name] = round(
                b["arrivals_per_sec"] / a["arrivals_per_sec"], 2)
    return out


def run(smoke: bool = False, full: bool = False) -> Tuple[List[Dict],
                                                          Dict[str, float]]:
    cells = CELLS[:1] if smoke else CELLS
    rows: List[Dict] = []
    for name, n_jobs, jc, pattern in cells:
        for mode, rng, vec in MODES:
            row = run_cell(name, n_jobs, jc, pattern, mode, rng, vec)
            rows.append(row)
            print(",".join(str(v) for v in row.values()), flush=True)
    if full:
        row = run_acceptance_row()
        rows.append(row)
        print(",".join(str(v) for v in row.values()), flush=True)
    sp = speedups(rows)
    for name, s in sp.items():
        print(f"[speedup {name}: {s}x fast vs legacy]")
    if "large" in sp and sp["large"] < LARGE_SPEEDUP_FLOOR:
        raise SystemExit(
            f"large-cell speedup {sp['large']}x is below the "
            f"{LARGE_SPEEDUP_FLOOR}x floor (the acceptance floor)")
    return rows, sp


def measure_trace_overhead() -> Dict:
    """Trace-on overhead of the medium/fast cell — the densest trace case,
    since the vectorized path executes ~10x fewer simulator events for the
    same traced work (the same asymmetry the speedup metric corrects for).

    Measures the tracer's *direct* cost: legs interleave untraced/traced
    (so box drift hits both equally), each timed run is preceded by a full
    GC collect and runs with the cyclic collector disabled, and each leg
    takes its best of 4. Collector scheduling is excluded deliberately —
    gen-2 collections scan the entire live heap, so their cost tracks
    total heap size and allocation count across the *whole* process
    (including every earlier benchmark cell), not tracer work; including
    them makes the cell flake on CI hardware while measuring the box, not
    the code. Enforces the ceiling: direct trace-on overhead must stay under
    TRACE_OVERHEAD_CEILING_PCT %. Kept out of ``run()``'s rows — the
    smoke-row schema is golden-locked."""
    import gc

    name, n_jobs, jc, pattern = CELLS[1]
    mode, rng, vec = MODES[1]  # fast: the hot path the tracer must not slow
    walls: Dict[bool, List[float]] = {False: [], True: []}
    gc_was_enabled = gc.isenabled()
    try:
        for _ in range(4):
            for leg in (False, True):
                gc.collect()
                gc.disable()
                try:
                    walls[leg].append(
                        run_cell(name, n_jobs, jc, pattern, mode, rng, vec,
                                 trace_run=leg)["wall_s"])
                finally:
                    if gc_was_enabled:
                        gc.enable()
    finally:
        if gc_was_enabled:
            gc.enable()
    off, on = min(walls[False]), min(walls[True])
    overhead_pct = round(100.0 * (on - off) / off, 2) if off > 0 else 0.0
    row = {"cell": name, "mode": mode, "wall_s_untraced": off,
           "wall_s_traced": on, "overhead_pct": overhead_pct,
           "ceiling_pct": TRACE_OVERHEAD_CEILING_PCT, "gc_excluded": True}
    print(f"[trace overhead {name}/{mode}: {overhead_pct}% "
          f"(untraced {off}s, traced {on}s, ceiling "
          f"{TRACE_OVERHEAD_CEILING_PCT}%)]", flush=True)
    if overhead_pct >= TRACE_OVERHEAD_CEILING_PCT:
        raise SystemExit(
            f"trace-on overhead {overhead_pct}% is at/above the "
            f"{TRACE_OVERHEAD_CEILING_PCT}% ceiling")
    return row


def check_against(baseline_path: str, rows: List[Dict],
                  sp: Dict[str, float]) -> None:
    """Regression guard vs a committed baseline: deterministic columns
    exact, speedup within CHECK_SPEEDUP_FRACTION of the baseline ratio."""
    with open(baseline_path) as f:
        base = json.load(f)
    base_by = {(r["cell"], r["mode"]): r for r in base["rows"]}
    failures: List[str] = []
    for r in rows:
        b = base_by.get((r["cell"], r["mode"]))
        if b is None:
            continue
        for col in ("n_jobs", "parties_per_job", "rounds_per_job",
                    "arrivals", "events"):
            if r[col] != b[col]:
                failures.append(
                    f"{r['cell']}/{r['mode']}: {col} {r[col]} != "
                    f"baseline {b[col]} (determinism broken)")
    for name, got in sp.items():
        want = base.get("speedups", {}).get(name)
        if want is None:
            continue
        floor = CHECK_SPEEDUP_FRACTION * want
        if got < floor:
            failures.append(
                f"{name}: speedup {got}x < {floor:.2f}x "
                f"(>{100 * (1 - CHECK_SPEEDUP_FRACTION):.0f}% drop vs "
                f"baseline {want}x)")
    if failures:
        print("[simcore regression check FAILED]", file=sys.stderr)
        for msg in failures:
            print("  " + msg, file=sys.stderr)
        raise SystemExit(1)
    print(f"[simcore regression check OK vs {baseline_path}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI per-commit: the small cell only, both modes")
    ap.add_argument("--full", action="store_true",
                    help="add the 5,000-job diurnal acceptance row")
    ap.add_argument("--check", default="",
                    help="baseline JSON to regression-check against")
    ap.add_argument("--out", default="BENCH_simcore.json",
                    help="write rows as JSON here ('' to skip)")
    args = ap.parse_args()
    print(HEADER)
    rows, sp = run(smoke=args.smoke, full=args.full)
    trace_overhead = measure_trace_overhead()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "simcore", "smoke": args.smoke,
                       "rows": rows, "speedups": sp,
                       "trace_overhead": trace_overhead}, f, indent=1)
        print(f"[wrote {args.out}: {len(rows)} rows]")
    if args.check:
        check_against(args.check, rows, sp)


if __name__ == "__main__":
    main()
