"""Cross-vehicle conformance harness: the scenario matrix, defended.

The fleet subsystem prices one ``WorkloadTrace`` on two execution
vehicles — the arrival-gated Fig. 6 ``JITScheduler`` (``strategy="jit"``)
and the per-job ``RoundEngine`` baselines (eager-AO, eager-λ, batched,
lazy). Every paper claim the benchmarks report (§2.2/Fig. 9 savings,
§4.3 robustness under intermittency and dropouts, §6.2 latency) is a
*paired* comparison between those vehicles, so the pairing itself must be
defended: if the vehicles ever drift onto different arrival sequences, or
the savings/latency invariants quietly stop holding on some corner of the
(strategy × availability pattern × capacity tier) matrix, the benchmark
numbers become fiction without any test failing.

``run_cell`` executes one matrix cell: the same synthetic trace through
every requested strategy (one fresh platform each, scheduler vehicle for
``"jit"``, engine baselines otherwise), recording every availability
sample through the ``ArrivalRecorder`` hook. It then checks the paired
invariants and returns a ``CellReport``:

  1. **arrival parity** — every vehicle sampled the identical per-party
     ``round -> (train_s, comm_s) | no-show`` sequence (the shared
     ``SimulatedParty`` RNG streams, §2.2 presence signal included);
  2. **Fig. 9 savings** — JIT bills at most ``(1 - min_savings_pct/100)``
     of eager-AO container-seconds on cells where the paper claims the
     60%+ fleet savings (the default-capacity tiers);
  3. **§6.2 latency band** — the JIT scheduler's pooled p50/p95
     aggregation latency exceeds eager-AO's by at most the cell's
     declared tolerance (the paper's "negligible latency impact" claim,
     presence-fair under dropout patterns since both vehicles now hear
     no-shows up front);
  4. **gold band** — on classed cells (``class_ranks`` cycles SLA ranks
     over the jobs), the rank-0 (gold) jobs' pooled §5.5 p95 lateness on
     the scheduler vehicle stays inside the declared
     ``gold_p95_lateness_band_s`` — class-rank pool priorities defended
     under genuine drain contention;
  5. **trace/billing reconciliation** — every vehicle runs under a
     ``repro.obs.Tracer``, and the container-seconds recomputed from its
     billed spans must equal the cluster's per-job ledger exactly (the
     trace as billing-correctness oracle). Failed cells attach the last
     N trace events per job to the ``CellReport`` so a nightly failure
     is diagnosable from the uploaded artifact alone.

Capacity tiers: ``default`` is the benchmark pool (8 containers, fast
fuse); ``tiny`` is an under-provisioned pool (2 containers, multi-second
fuse) whose drains genuinely contend, queue and get preempted. The
``long_horizon_matrix`` cells stretch every job to many diurnal periods
(multi-day traces) and are meant for the nightly tier.

``tests/test_conformance.py`` locks the full default matrix; run it
standalone with ``python -m repro.fleet.conformance``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.metrics import percentile
from repro_torch.fleet.fleet import FleetResult
from repro_torch.fleet.traces import (
    MeasuredRound,
    WorkloadTrace,
    fleet_from_measured,
    synthetic_fleet,
)

#: tier name -> containers in the shared aggregation pool
CAPACITY_TIERS: Dict[str, int] = {"tiny": 2, "default": 8}
#: tier name -> fuse cost; the tiny tier pairs few containers with slow
#: cores so aggregation work actually contends (see benchmarks.fleet)
TIER_T_PAIR_S: Dict[str, float] = {"tiny": 2.0, "default": 0.05}

#: the availability patterns of the conformance matrix (every single
#: pattern; "mixed" is a cycle of these and adds no new cell)
CONFORMANCE_PATTERNS: Tuple[str, ...] = (
    "steady", "diurnal", "straggler", "intermittent", "dropout")

#: the measured cell family replays a recorded real-training export
#: (``fleet_from_measured``) instead of sampling synthetic availability —
#: the carried ROADMAP follow-up: the arrival-parity invariant must hold
#: when BOTH vehicles replay the same ``measured_rounds`` verbatim
MEASURED_PATTERN = "measured"


def pseudo_measured_export(
    *,
    n_parties: int = 6,
    rounds: int = 5,
    seed: int = 0,
    mean_train_s: float = 45.0,
    comm_s: float = 0.5,
) -> Tuple[FLJobSpec, List[MeasuredRound]]:
    """A deterministic stand-in for ``FLJobRuntime.measured_rounds``: one
    job spec plus per-round ``{party: (train_s, comm_s)}`` observations,
    shaped like a real export (per-party mean offsets, per-round jitter)
    but reproducible without running JAX training — so the measured cell
    family can run in the fast CI tier."""
    rng = np.random.default_rng(seed)
    pids = [f"mp{i}" for i in range(n_parties)]
    means = mean_train_s * rng.uniform(0.7, 1.3, size=n_parties)
    measured: List[MeasuredRound] = [
        {pid: (float(means[i] * rng.uniform(0.9, 1.15)), comm_s)
         for i, pid in enumerate(pids)}
        for _ in range(rounds)
    ]
    spec = FLJobSpec(
        job_id="measured",
        model_arch="measured-export",
        model_bytes=50 << 20,
        rounds=rounds,
        parties={
            pid: PartySpec(pid, epoch_time_s=float(means[i]),
                           dataset_size=1000)
            for i, pid in enumerate(pids)
        },
    )
    return spec, measured

#: every registered deployment strategy; "jit" runs the scheduler vehicle,
#: the rest run per-job RoundEngine baselines
CONFORMANCE_STRATEGIES: Tuple[str, ...] = (
    "jit", "eager_ao", "eager_serverless", "batched", "lazy")

#: (job_id, party_id) -> availability samples in round order; None is a
#: §2.2 no-show. Two vehicles conform when these logs are equal.
ArrivalLog = Dict[Tuple[str, str], List[Optional[Tuple[float, float]]]]


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One (pattern × capacity tier) cell of the scenario matrix, with its
    declared claims: which savings floor applies and how much extra §6.2
    latency the JIT vehicle is allowed over the always-on baseline."""

    pattern: str
    tier: str = "default"
    n_jobs: int = 5
    seed: int = 0
    stagger_s: float = 30.0
    horizon_rounds: Optional[int] = None
    # party stream scheme: "pcg64" (sequential, the default everywhere) or
    # "philox" (counter-based presampled grids + the vectorized scheduler
    # fast path) — the vectorized_matrix cells prove the paired-stream
    # invariants hold on the fleet-at-scale path too
    rng: str = "pcg64"
    # SLA-class ranks (repro.online ladder: 0=gold, 1=silver,
    # 2=best_effort) cycled over the trace's jobs by index; None keeps
    # every job rank 0 — the single-class matrix, bit-identical to the
    # pre-class-rank cells
    class_ranks: Optional[Tuple[int, ...]] = None
    # declared claims / tolerance bands
    min_savings_pct: Optional[float] = 60.0  # None: savings not claimed
    p50_band_s: float = 30.0  # allowed JIT p50 latency excess over eager-AO
    p95_band_s: float = 120.0  # ... and p95
    # gold band: pooled p95 §5.5 lateness over the rank-0 jobs on the JIT
    # scheduler run must stay within this many seconds (None: no claim) —
    # the class-rank pool priorities defended as a matrix invariant
    gold_p95_lateness_band_s: Optional[float] = None

    def __post_init__(self):
        if self.tier not in CAPACITY_TIERS:
            raise ValueError(
                f"tier must be one of {sorted(CAPACITY_TIERS)}, "
                f"got {self.tier!r}")
        if self.rng not in ("pcg64", "philox"):
            raise ValueError(
                f"rng must be 'pcg64' or 'philox', got {self.rng!r}")

    @property
    def capacity(self) -> int:
        return CAPACITY_TIERS[self.tier]

    @property
    def t_pair_s(self) -> float:
        return TIER_T_PAIR_S[self.tier]

    @property
    def name(self) -> str:
        h = f"-h{self.horizon_rounds}" if self.horizon_rounds else ""
        r = f"-{self.rng}" if self.rng != "pcg64" else ""
        c = "-classed" if self.class_ranks else ""
        return f"{self.pattern}/{self.tier}{h}{r}{c}"

    def class_rank_of(self, trace: WorkloadTrace) -> Optional[Dict[str, int]]:
        """job_id -> SLA-class rank, cycling ``class_ranks`` over the
        trace's jobs in order; None on single-class cells."""
        if not self.class_ranks:
            return None
        return {jt.job_id: self.class_ranks[i % len(self.class_ranks)]
                for i, jt in enumerate(trace.jobs)}

    def trace(self) -> WorkloadTrace:
        if self.pattern == MEASURED_PATTERN:
            # measured replay: staggered copies of one recorded run
            # (fleet_from_measured); round count is fixed by the export
            if self.horizon_rounds is not None:
                raise ValueError(
                    "measured cells replay recorded rounds exactly; "
                    "horizon_rounds does not apply")
            spec, measured = pseudo_measured_export(seed=self.seed)
            trace = fleet_from_measured(
                spec, measured, n_jobs=self.n_jobs,
                stagger_s=self.stagger_s)
            trace.cluster_capacity = self.capacity
            return trace
        return synthetic_fleet(
            self.n_jobs, self.pattern, seed=self.seed,
            stagger_s=self.stagger_s, cluster_capacity=self.capacity,
            horizon_rounds=self.horizon_rounds)


#: events per job attached to a failed cell's trace excerpt
TRACE_EXCERPT_EVENTS = 20


@dataclasses.dataclass
class VehicleRun:
    """One strategy's run of a cell trace on its execution vehicle."""

    strategy: str
    vehicle: str  # "scheduler" | "engine"
    arrivals: ArrivalLog
    result: FleetResult
    tracer: Optional[object] = None  # repro.obs.Tracer when traced


@dataclasses.dataclass
class CellReport:
    """One conformance cell: the per-strategy runs and every violated
    invariant (empty ``failures`` == the cell conforms). Failed cells
    carry ``trace_excerpts``: strategy -> job -> the cell's last
    ``TRACE_EXCERPT_EVENTS`` trace events for that job."""

    spec: CellSpec
    runs: Dict[str, VehicleRun]
    failures: List[str]
    trace_excerpts: Dict[str, Dict[str, List[Dict[str, object]]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return not self.failures

    def savings_pct(self) -> Optional[float]:
        """JIT savings vs eager-AO container-seconds (Fig. 9), if both ran."""
        jit = self.runs.get("jit")
        ao = self.runs.get("eager_ao")
        if jit is None or ao is None:
            return None
        ao_cs = ao.result.fleet.container_seconds
        if ao_cs <= 0.0:
            return None
        return 100.0 * (1.0 - jit.result.fleet.container_seconds / ao_cs)

    def summary(self) -> Dict[str, object]:
        row: Dict[str, object] = {
            "cell": self.spec.name,
            "n_jobs": self.spec.n_jobs,
            "capacity": self.spec.capacity,
            "passed": self.passed,
            "savings_vs_ao_pct": (
                round(self.savings_pct(), 2)
                if self.savings_pct() is not None else None),
        }
        jit = self.runs.get("jit")
        ao = self.runs.get("eager_ao")
        if jit is not None and ao is not None:
            row["jit_p50_latency_s"] = round(
                jit.result.fleet.p50_latency_s, 3)
            row["ao_p50_latency_s"] = round(ao.result.fleet.p50_latency_s, 3)
        if self.failures:
            row["failures"] = list(self.failures)
        return row


def _first_divergence(a: ArrivalLog, b: ArrivalLog) -> str:
    """Human-readable location of the first arrival-sequence mismatch."""
    for key in sorted(set(a) | set(b)):
        xs, ys = a.get(key), b.get(key)
        if xs is None or ys is None:
            return f"party {key} sampled by one vehicle only"
        if xs != ys:
            for r, (x, y) in enumerate(zip(xs, ys)):
                if x != y:
                    return f"party {key} round {r}: {x!r} != {y!r}"
            return (f"party {key}: {len(xs)} vs {len(ys)} sampled rounds")
    return "logs empty"


def run_cell(
    spec: CellSpec,
    strategies: Tuple[str, ...] = CONFORMANCE_STRATEGIES,
    trace_runs: bool = True,
) -> CellReport:
    """Run one matrix cell through every strategy's vehicle and check the
    paired invariants. Each strategy gets a fresh platform (simulated
    clusters are single-shot) but the identical trace and party seeds.
    With ``trace_runs`` (the default) every vehicle records a
    ``repro.obs`` trace, which is reconciled against the billed ledger as
    invariant 5 and excerpted onto the report if the cell fails."""
    from repro_torch.api import Platform  # deferred: api imports repro_torch.fleet
    from repro_torch.obs import Tracer

    runs: Dict[str, VehicleRun] = {}
    failures: List[str] = []
    trace = spec.trace()  # immutable; one build serves every strategy
    # every vehicle gets the SAME job->rank map: class ranks change pool
    # scheduling only, so arrival parity must survive a classed cell
    ranks = spec.class_rank_of(trace)
    for strategy in strategies:
        log: ArrivalLog = {}

        def recorder(job_id, pid, round_idx, sample, _log=log):
            _log.setdefault((job_id, pid), []).append(sample)

        tracer = Tracer() if trace_runs else None
        platform = Platform(
            ClusterConfig(capacity=spec.capacity),
            AggregationEstimator(t_pair_s=spec.t_pair_s),
            tracer=tracer,
        )
        runner = platform.submit_fleet(
            trace, strategy=strategy, recorder=recorder, rng=spec.rng,
            class_rank_of=ranks)
        platform.run()
        if not runner.all_done:
            failures.append(f"[{spec.name}] {strategy}: fleet did not run "
                            f"every job to completion")
        if tracer is not None:
            # invariant 5: span-derived container-seconds and preempt
            # events must reconcile with the cluster's billed ledgers
            failures.extend(
                f"[{spec.name}] {strategy}: trace/billing: {msg}"
                for msg in tracer.reconcile(platform.cluster))
        runs[strategy] = VehicleRun(
            strategy=strategy,
            vehicle="scheduler" if strategy == "jit" else "engine",
            arrivals=log,
            result=runner.result(),
            tracer=tracer,
        )
    failures.extend(check_invariants(spec, runs, class_rank_of=ranks))
    excerpts: Dict[str, Dict[str, List[Dict[str, object]]]] = {}
    if failures and trace_runs:
        excerpts = {
            strategy: run.tracer.tail_by_job(TRACE_EXCERPT_EVENTS)
            for strategy, run in runs.items() if run.tracer is not None
        }
    return CellReport(spec=spec, runs=runs, failures=failures,
                      trace_excerpts=excerpts)


def check_invariants(spec: CellSpec,
                     runs: Dict[str, VehicleRun],
                     class_rank_of: Optional[Dict[str, int]] = None,
                     ) -> List[str]:
    """The paired invariants of one cell (see module docstring), plus the
    gold-band invariant on cells that declare one."""
    failures: List[str] = []
    # 1. arrival parity: every vehicle saw the same availability sequences
    names = list(runs)
    ref = runs[names[0]]
    for name in names[1:]:
        if runs[name].arrivals != ref.arrivals:
            failures.append(
                f"[{spec.name}] arrival sequences diverge between "
                f"{names[0]} and {name}: "
                f"{_first_divergence(ref.arrivals, runs[name].arrivals)}")
    # 2. Fig. 9 savings floor, where the cell claims it
    jit, ao = runs.get("jit"), runs.get("eager_ao")
    if spec.min_savings_pct is not None and jit and ao:
        jit_cs = jit.result.fleet.container_seconds
        ao_cs = ao.result.fleet.container_seconds
        cap = 1.0 - spec.min_savings_pct / 100.0
        if not (ao_cs > 0.0 and jit_cs <= cap * ao_cs):
            failures.append(
                f"[{spec.name}] JIT bills {jit_cs:.1f} container-seconds "
                f"vs eager-AO {ao_cs:.1f}; claimed >= "
                f"{spec.min_savings_pct:.0f}% savings (<= {cap:.2f}x)")
    # 3. §6.2 latency within the declared band of the always-on baseline
    if jit and ao:
        for q, band in [("p50", spec.p50_band_s), ("p95", spec.p95_band_s)]:
            jl = getattr(jit.result.fleet, f"{q}_latency_s")
            al = getattr(ao.result.fleet, f"{q}_latency_s")
            if jl - al > band:
                failures.append(
                    f"[{spec.name}] JIT {q} latency {jl:.3f}s exceeds "
                    f"eager-AO {al:.3f}s by more than the declared "
                    f"{band:.1f}s band")
    # 4. gold band: on classed cells, §5.5 class-rank pool priorities must
    #    keep the rank-0 (gold) jobs' pooled p95 lateness inside the
    #    declared band on the scheduler vehicle, even while lower classes
    #    queue and absorb preemptions on a contended pool
    if spec.gold_p95_lateness_band_s is not None and jit:
        ranks = class_rank_of or {}
        gold = [x for job_id, m in jit.result.jobs.items()
                if ranks.get(job_id, 0) == 0
                for x in m.round_lateness]
        if not gold:
            failures.append(
                f"[{spec.name}] gold band declared but the JIT run has no "
                f"rank-0 lateness samples")
        else:
            p95 = percentile(gold, 0.95)
            band = spec.gold_p95_lateness_band_s
            if p95 > band:
                failures.append(
                    f"[{spec.name}] gold p95 lateness {p95:.3f}s exceeds "
                    f"the declared {band:.1f}s band "
                    f"({len(gold)} rank-0 samples)")
    return failures


# --------------------------------------------------------------------------
# the declared scenario matrix
# --------------------------------------------------------------------------
def default_matrix(*, n_jobs: int = 5, seed: int = 0) -> List[CellSpec]:
    """Every (pattern × {default, tiny}) cell with its declared claims.

    The savings floor is claimed only on default-capacity cells (the
    paper's Fig. 9 setting); tiny-tier cells still demand arrival parity
    and a latency band, but under an under-provisioned pool the JIT
    drains queue behind each other, so the band is wider and no savings
    floor applies (always-on containers live OUTSIDE the pooled capacity
    and are never squeezed by it)."""
    cells: List[CellSpec] = []
    for pattern in CONFORMANCE_PATTERNS:
        # bands declared at ~2-3x the deterministic observed excess, so a
        # regression that doubles JIT latency over the baseline fails the
        # cell while benign jitter from future estimator tweaks does not
        cells.append(CellSpec(
            pattern=pattern, tier="default", n_jobs=n_jobs, seed=seed,
            min_savings_pct=60.0, p50_band_s=5.0, p95_band_s=15.0))
        cells.append(CellSpec(
            pattern=pattern, tier="tiny", n_jobs=n_jobs, seed=seed,
            min_savings_pct=None, p50_band_s=20.0, p95_band_s=80.0))
    # the class-rank cell (§5.5 SLA pool priorities): a contended
    # tiny-tier pool with every job submitted at once and a
    # gold/silver/best_effort ladder cycled across the fleet — class-rank
    # scheduling must hold arrival parity AND keep gold p95 lateness
    # inside its band while lower classes queue behind the gold drains
    # and absorb the preemptions (observed: ~15.6 s gold p95, ~8
    # preemptions; bands at ~2.5-4x observed)
    cells.append(CellSpec(
        pattern="steady", tier="tiny", n_jobs=12, seed=seed,
        stagger_s=0.0, class_ranks=(0, 1, 2), min_savings_pct=None,
        p50_band_s=40.0, p95_band_s=120.0,
        gold_p95_lateness_band_s=60.0))
    # the measured cell family (carried ROADMAP follow-up): replayed
    # real-run exports must hold the same arrival-parity invariant — a
    # verbatim replay has even less room for divergence than sampled
    # patterns, so any drift here is a vehicle bug, not workload noise
    cells.append(CellSpec(
        pattern=MEASURED_PATTERN, tier="default", n_jobs=n_jobs, seed=seed,
        min_savings_pct=60.0, p50_band_s=5.0, p95_band_s=15.0))
    cells.append(CellSpec(
        pattern=MEASURED_PATTERN, tier="tiny", n_jobs=n_jobs, seed=seed,
        min_savings_pct=None, p50_band_s=20.0, p95_band_s=80.0))
    return cells


def vectorized_matrix(*, n_jobs: int = 5, seed: int = 0) -> List[CellSpec]:
    """The fleet-at-scale cells: every availability pattern on philox
    counter streams, where the "jit" strategy runs the VECTORIZED
    scheduler path (presampled rounds, analytic triggers) while the engine
    baselines read the same grids scalar-wise through
    ``CounterStreamParty.sample_round`` — so arrival parity here proves
    the fast path and the per-event vehicles price identical sequences.
    Claims mirror the default matrix's default-tier cells."""
    return [
        CellSpec(pattern=pattern, tier="default", n_jobs=n_jobs, seed=seed,
                 rng="philox",
                 min_savings_pct=60.0, p50_band_s=5.0, p95_band_s=15.0)
        for pattern in CONFORMANCE_PATTERNS
    ]


def long_horizon_matrix(*, n_jobs: int = 6, seed: int = 0,
                        horizon_rounds: int = 24) -> List[CellSpec]:
    """Nightly cells: long-horizon diurnal/intermittent traces spanning
    many availability periods, on both capacity tiers."""
    cells: List[CellSpec] = []
    for pattern in ("diurnal", "intermittent", "dropout"):
        cells.append(CellSpec(
            pattern=pattern, tier="default", n_jobs=n_jobs, seed=seed,
            horizon_rounds=horizon_rounds,
            min_savings_pct=60.0, p50_band_s=30.0, p95_band_s=90.0))
        cells.append(CellSpec(
            pattern=pattern, tier="tiny", n_jobs=n_jobs, seed=seed,
            horizon_rounds=horizon_rounds,
            min_savings_pct=None, p50_band_s=90.0, p95_band_s=420.0))
    return cells


def run_matrix(cells: Optional[List[CellSpec]] = None,
               strategies: Tuple[str, ...] = CONFORMANCE_STRATEGIES,
               ) -> List[CellReport]:
    return [run_cell(spec, strategies)
            for spec in (cells if cells is not None else default_matrix())]


def export_traces(reports: List[CellReport], out_dir: str) -> List[str]:
    """Write one Perfetto-loadable chrome trace per (cell, strategy) run
    into ``out_dir`` (created if missing), plus a ``failures.json`` with
    the per-job trace excerpts of every failed cell. Returns the paths."""
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    failed: Dict[str, object] = {}
    for rep in reports:
        slug = rep.spec.name.replace("/", "_")
        for strategy, run in rep.runs.items():
            if run.tracer is None:
                continue
            path = os.path.join(out_dir, f"{slug}-{strategy}.json")
            run.tracer.export_chrome(path)
            paths.append(path)
        if rep.failures:
            failed[rep.spec.name] = {
                "failures": rep.failures,
                "trace_excerpts": rep.trace_excerpts,
            }
    if failed:
        path = os.path.join(out_dir, "failures.json")
        with open(path, "w") as f:
            json.dump(failed, f, indent=1)
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="run a conformance matrix and report per-cell "
                    "invariant failures")
    ap.add_argument("--matrix", default="default",
                    choices=("default", "vectorized", "long-horizon"),
                    help="which declared cell matrix to run")
    ap.add_argument("--trace-out", default="",
                    help="directory for per-(cell, strategy) chrome traces "
                         "and failed-cell excerpts (nightly artifact)")
    args = ap.parse_args(argv)
    cells = {
        "default": default_matrix,
        "vectorized": vectorized_matrix,
        "long-horizon": long_horizon_matrix,
    }[args.matrix]()
    reports = run_matrix(cells)
    bad = 0
    for rep in reports:
        print(rep.summary())
        for f in rep.failures:
            print("  FAIL:", f)
            bad += 1
    print(f"{len(reports)} cells, "
          f"{sum(1 for r in reports if r.passed)} conforming")
    if args.trace_out:
        paths = export_traces(reports, args.trace_out)
        print(f"[wrote {len(paths)} trace artifacts to {args.trace_out}]")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
