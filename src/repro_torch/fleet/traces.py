"""Workload traces for fleet-scale simulation (``repro.fleet``).

The paper's headline claim (Fig. 9, 60%+ resource savings) is a *fleet*
result: many concurrent FL jobs with intermittently-available parties
contending for one aggregation cluster. A ``WorkloadTrace`` describes such
a fleet declaratively — a list of ``JobTrace`` entries, each with a
submission time, a model size, a round count, a quorum, and one availability
``PartyPattern`` per party — in a JSON-lines format that can be generated
synthetically (``synthetic_fleet``), exported from a real training run
(``trace_from_measured`` over ``FLJobRuntime.measured_rounds``), saved,
and replayed bit-identically (HPC workload-simulator style: generated and
replayable traces feeding one scheduler).

Availability patterns (per party, sampled once per round):

  steady        gaussian jitter around the party's true mean train time
  diurnal       the steady time modulated sinusoidally over the nominal
                round cadence (device busy at peak hours -> slower rounds;
                phased on round index so strategy comparisons stay paired)
  straggler     steady, but with probability ``straggler_prob`` the round
                takes ``straggler_factor`` x longer (heavy tail)
  intermittent  the update lands at a uniformly random time inside the
                job's ``window_s`` round window (the paper's §4.3 scheme)

Any pattern may additionally drop out of a round entirely with
``dropout_prob`` (§2.2 no-shows). ``declared_train_s`` is what the party
*reports* in its job spec (§5.2) — deliberately distinct from the true
``mean_train_s`` so online t_rnd calibration has something to learn.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.jobspec import FLJobSpec, PartySpec

PATTERNS = ("steady", "diurnal", "straggler", "intermittent")

MeasuredRound = Dict[str, Tuple[float, float]]  # pid -> (train_s, comm_s)


@dataclasses.dataclass(frozen=True)
class PartyPattern:
    """One party's per-round availability process (trace-serializable)."""

    pattern: str = "steady"
    mean_train_s: float = 60.0
    jitter_rel: float = 0.05
    comm_s: float = 1.0
    dropout_prob: float = 0.0  # per-round no-show probability (§2.2)
    # straggler tail
    straggler_prob: float = 0.0
    straggler_factor: float = 4.0
    # diurnal: train *= 1 + amplitude*sin(2π(t_nom+phase)/period), with
    # t_nom = round_idx * mean_train_s (nominal cadence, strategy-paired)
    period_s: float = 600.0
    amplitude: float = 0.5
    phase_s: float = 0.0
    # intermittent: arrival uniform in [comm_s, window_s]
    window_s: float = 0.0
    # what the party reports in the job spec (§5.2); defaults to the truth
    declared_train_s: Optional[float] = None

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(
                f"pattern must be one of {PATTERNS}, got {self.pattern!r}")
        if self.mean_train_s <= 0.0:
            raise ValueError("mean_train_s must be > 0")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError("dropout_prob must be in [0, 1)")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if self.pattern == "intermittent" and self.window_s <= self.comm_s:
            raise ValueError(
                "intermittent parties need window_s > comm_s (§4.3)")

    @property
    def declared(self) -> float:
        """The train-time estimate the party reports up front (§5.2)."""
        return (self.declared_train_s if self.declared_train_s is not None
                else self.mean_train_s)

    def to_party_spec(self, party_id: str, model_bytes: int) -> PartySpec:
        # bandwidths chosen so the predictor's t_comm == this comm_s
        bw = 2.0 * model_bytes / max(self.comm_s, 1e-9)
        return PartySpec(
            party_id,
            mode="intermittent" if self.pattern == "intermittent"
            else "active",
            epoch_time_s=self.declared,
            dataset_size=1000,
            bw_down=bw, bw_up=bw,
        )


@dataclasses.dataclass
class JobTrace:
    """One FL job in a fleet trace: spec-level knobs + party availability,
    or a recorded real run (``measured_rounds``) for exact replay."""

    job_id: str
    model_bytes: int
    rounds: int
    submit_s: float = 0.0
    quorum_fraction: float = 1.0
    window_s: Optional[float] = None  # round-close window (§4.3)
    seed: int = 0
    parties: Dict[str, PartyPattern] = dataclasses.field(default_factory=dict)
    # recorded (train_s, comm_s) per party per round — FLJobRuntime export
    measured_rounds: Optional[List[MeasuredRound]] = None

    def __post_init__(self):
        if not self.parties and not self.measured_rounds:
            raise ValueError(
                f"job {self.job_id!r} needs parties or measured_rounds")
        if self.measured_rounds:
            self.rounds = len(self.measured_rounds)
        needs_window = any(
            p.pattern == "intermittent" or p.dropout_prob > 0.0
            for p in self.parties.values()
        )
        if needs_window and not self.window_s:
            raise ValueError(
                f"job {self.job_id!r}: intermittent/dropout parties need a "
                f"window_s round-close window (§4.3)")

    @property
    def party_ids(self) -> List[str]:
        if self.parties:
            return list(self.parties)
        seen: Dict[str, None] = {}
        for rnd in self.measured_rounds or []:
            for pid in rnd:
                seen.setdefault(pid)
        return list(seen)

    def to_jobspec(self) -> FLJobSpec:
        if self.parties:
            specs = {
                pid: pat.to_party_spec(pid, self.model_bytes)
                for pid, pat in self.parties.items()
            }
        else:
            # synthesize specs from the first measured observation per party
            specs = {}
            for pid in self.party_ids:
                train, comm = next(
                    r[pid] for r in self.measured_rounds if pid in r)
                specs[pid] = PartyPattern(
                    mean_train_s=max(train, 1e-6), comm_s=max(comm, 1e-9),
                ).to_party_spec(pid, self.model_bytes)
        return FLJobSpec(
            job_id=self.job_id,
            model_arch="fleet-trace",
            model_bytes=self.model_bytes,
            rounds=self.rounds,
            quorum_fraction=self.quorum_fraction,
            t_wait_s=self.window_s,
            parties=specs,
        )

    def to_dict(self) -> dict:
        # asdict recurses into the PartyPattern values; json serializes the
        # measured (train, comm) tuples as lists, from_dict restores them
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobTrace":
        d = dict(d)
        d["parties"] = {
            pid: PartyPattern(**p) for pid, p in (d.get("parties") or {}).items()
        }
        if d.get("measured_rounds") is not None:
            d["measured_rounds"] = [
                {pid: (float(tc[0]), float(tc[1])) for pid, tc in rnd.items()}
                for rnd in d["measured_rounds"]
            ]
        return cls(**d)


@dataclasses.dataclass
class WorkloadTrace:
    """An ordered fleet of jobs; JSON-lines serializable and replayable.

    ``cluster_capacity`` is the capacity tier the trace was generated to
    stress (containers in the shared aggregation pool); ``None`` means the
    consumer's default. It rides along in the header line so a saved
    capacity-stress trace replays on the cluster size it was meant for
    (``benchmarks.fleet.simulate`` honours it).
    """

    jobs: List[JobTrace] = dataclasses.field(default_factory=list)
    name: str = "fleet"
    cluster_capacity: Optional[int] = None

    def __post_init__(self):
        if self.cluster_capacity is not None and self.cluster_capacity < 1:
            raise ValueError(
                f"cluster_capacity must be >= 1, got {self.cluster_capacity}")

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def dumps(self) -> str:
        head = {"kind": "workload-trace", "version": 1, "name": self.name,
                "n_jobs": self.n_jobs}
        if self.cluster_capacity is not None:
            head["cluster_capacity"] = self.cluster_capacity
        lines = [json.dumps(head)]
        lines += [json.dumps({"kind": "job", **j.to_dict()}, sort_keys=True)
                  for j in self.jobs]
        return "\n".join(lines) + "\n"

    @classmethod
    def loads(cls, text: str) -> "WorkloadTrace":
        name, jobs, capacity = "fleet", [], None
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            kind = d.pop("kind", "job")
            if kind == "workload-trace":
                name = d.get("name", name)
                capacity = d.get("cluster_capacity")
                continue
            jobs.append(JobTrace.from_dict(d))
        return cls(jobs=jobs, name=name, cluster_capacity=capacity)

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path) -> "WorkloadTrace":
        with open(path) as f:
            return cls.loads(f.read())


# --------------------------------------------------------------------------
# synthetic generators: job mixes x availability patterns
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class JobClass:
    name: str
    n_parties: int
    model_bytes: int
    mean_train_s: float
    rounds: int
    comm_s: float


#: Small/medium/large mix (rounds scaled so fleet makespans overlap and the
#: cluster actually sees cross-job contention).
JOB_MIX: Tuple[JobClass, ...] = (
    JobClass("small", 8, 50 << 20, 60.0, 6, 0.5),
    JobClass("medium", 16, 200 << 20, 180.0, 4, 1.5),
    JobClass("large", 32, 500 << 20, 420.0, 2, 3.0),
)

#: Pattern assignment cycle for ``pattern="mixed"`` fleets.
MIXED_PATTERNS = ("steady", "diurnal", "straggler", "intermittent", "dropout")


def make_pattern(
    kind: str,
    mean_train_s: float,
    comm_s: float,
    rng: np.random.Generator,
    *,
    window_s: float,
    jitter_rel: float = 0.05,
    declare_err: float = 0.3,
) -> PartyPattern:
    """One party's availability pattern; ``kind="dropout"`` is steady with a
    20% per-round no-show rate. The declared (§5.2) train time misses the
    truth by up to ``declare_err`` so t_rnd calibration has work to do."""
    declared = float(mean_train_s
                     * rng.uniform(1.0 - declare_err, 1.0 + declare_err))
    common = dict(
        mean_train_s=float(mean_train_s), jitter_rel=jitter_rel,
        comm_s=comm_s, declared_train_s=declared,
    )
    if kind == "steady":
        return PartyPattern(pattern="steady", **common)
    if kind == "dropout":
        return PartyPattern(pattern="steady", dropout_prob=0.2, **common)
    if kind == "straggler":
        return PartyPattern(pattern="straggler", straggler_prob=0.15,
                            straggler_factor=3.0, **common)
    if kind == "diurnal":
        return PartyPattern(
            pattern="diurnal", period_s=20.0 * mean_train_s, amplitude=0.5,
            phase_s=float(rng.uniform(0.0, 20.0 * mean_train_s)), **common)
    if kind == "intermittent":
        return PartyPattern(pattern="intermittent", window_s=window_s,
                            **common)
    raise ValueError(
        f"unknown availability pattern {kind!r}; "
        f"expected one of {MIXED_PATTERNS}")


def synthetic_fleet(
    n_jobs: int = 16,
    pattern: str = "mixed",
    *,
    seed: int = 0,
    stagger_s: float = 30.0,
    job_mix: Tuple[JobClass, ...] = JOB_MIX,
    cluster_capacity: Optional[int] = None,
    horizon_rounds: Optional[int] = None,
) -> WorkloadTrace:
    """The default fleet: ``n_jobs`` jobs cycling through the small/medium/
    large mix, submitted ``stagger_s`` apart, each party following the given
    availability pattern ("mixed" cycles patterns across jobs).

    Scenario-matrix knobs (capacity-stress and long-horizon sweeps):

      cluster_capacity   the aggregation-pool size the trace should run on,
                         recorded in the trace header — tiny values (1-2)
                         produce preemption-heavy contention for the same
                         job mix
      horizon_rounds     overrides every job's round count, stretching the
                         fleet to a long horizon; diurnal parties then span
                         many availability periods (multi-day traces)
    """
    if horizon_rounds is not None and horizon_rounds < 1:
        raise ValueError(f"horizon_rounds must be >= 1, got {horizon_rounds}")
    rng = np.random.default_rng(seed)
    jobs: List[JobTrace] = []
    for k in range(n_jobs):
        jc = job_mix[k % len(job_mix)]
        kind = (MIXED_PATTERNS[k % len(MIXED_PATTERNS)]
                if pattern == "mixed" else pattern)
        # window comfortably past the straggler tail so §4.3 only drops
        # genuine no-shows
        window = 4.0 * jc.mean_train_s * 1.6 + jc.comm_s
        needs_window = kind in ("intermittent", "dropout")
        parties = {
            f"{jc.name}{k}-p{i}": make_pattern(
                kind, jc.mean_train_s * rng.uniform(0.8, 1.4), jc.comm_s,
                rng, window_s=window)
            for i in range(jc.n_parties)
        }
        jobs.append(JobTrace(
            job_id=f"{jc.name}{k}",
            model_bytes=jc.model_bytes,
            rounds=horizon_rounds if horizon_rounds is not None
            else jc.rounds,
            submit_s=k * stagger_s,
            quorum_fraction=0.8 if kind == "dropout" else 1.0,
            window_s=window if needs_window else None,
            seed=seed + k,
            parties=parties,
        ))
    name = f"synthetic-{pattern}-{n_jobs}"
    if cluster_capacity is not None:
        name += f"-cap{cluster_capacity}"
    if horizon_rounds is not None:
        name += f"-h{horizon_rounds}"
    return WorkloadTrace(jobs=jobs, name=name,
                         cluster_capacity=cluster_capacity)


# --------------------------------------------------------------------------
# exporters: real training runs -> replayable fleet traces
# --------------------------------------------------------------------------
def trace_from_measured(
    spec: FLJobSpec,
    measured_rounds: List[MeasuredRound],
    *,
    job_id: Optional[str] = None,
    submit_s: float = 0.0,
) -> JobTrace:
    """Convert one real run's ``FLJobRuntime.measured_rounds`` into a
    replayable ``JobTrace`` (arrivals are replayed exactly, not re-sampled)."""
    if not measured_rounds:
        raise ValueError("trace_from_measured needs >= 1 measured round")
    return JobTrace(
        job_id=job_id or spec.job_id,
        model_bytes=spec.model_bytes,
        rounds=len(measured_rounds),
        submit_s=submit_s,
        quorum_fraction=spec.quorum_fraction,
        window_s=spec.t_wait_s,
        measured_rounds=[dict(r) for r in measured_rounds],
    )


def fleet_from_measured(
    spec: FLJobSpec,
    measured_rounds: List[MeasuredRound],
    n_jobs: int = 16,
    *,
    stagger_s: float = 30.0,
) -> WorkloadTrace:
    """Replay one real run at fleet scale: ``n_jobs`` staggered copies of
    the measured arrivals contending for one aggregation cluster."""
    jobs = [
        trace_from_measured(
            spec, measured_rounds,
            job_id=f"{spec.job_id}-r{k}", submit_s=k * stagger_s)
        for k in range(n_jobs)
    ]
    return WorkloadTrace(jobs=jobs, name=f"measured-{spec.job_id}-x{n_jobs}")
