"""``FleetRunner`` — drive a ``WorkloadTrace`` over one shared cluster.

One runner wires a fleet trace onto the platform's simulator/cluster/
estimator and runs every job to completion under ONE deployment strategy:

  * ``strategy="jit"`` — the Fig. 6 multi-job ``JITScheduler`` in
    arrival-gated mode: per-job ``SimulatedParty`` processes deliver update
    arrivals into ``deliver_update`` (online t_rnd calibration), drains are
    gated on actual quorum arrival, and each round's completion is timed
    against its true last arrival — the scheduler vehicle's §6.2
    ``aggregation_latency``, previously unobservable.
  * any other registered strategy name or ``PolicyConfig`` — one
    ``RoundEngine`` per job on the same shared cluster, driven by the same
    party processes through ``FleetArrivalSource``, so eager-AO / eager-λ /
    batched / lazy baselines price identical arrival sequences.

Entry point: ``Platform.submit_fleet(trace, strategy=...)`` then
``platform.run()``; ``runner.result()`` returns per-job ``JobMetrics``
plus the fleet-level rollup (``core.metrics.fleet_rollup``): total
container-seconds and cost, pooled p50/p95 latency and lateness,
preemption/deploy counts and the cluster-utilization timeline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Set, Union

import numpy as np

from repro_torch.core.cluster import Cluster
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import FleetMetrics, JobMetrics, fleet_rollup
from repro_torch.core.policy import PolicyConfig, as_policy, get_strategy
from repro_torch.core.prediction import VectorizedUpdatePredictor
from repro_torch.core.scheduler import JITScheduler
from repro_torch.core.strategies import RoundEngine
from repro_torch.fleet.parties import (
    ArrivalRecorder,
    FleetArrivalSource,
    build_party_processes,
)
from repro_torch.fleet.traces import JobTrace, WorkloadTrace


@dataclasses.dataclass
class FleetResult:
    """Per-job metrics + the fleet-level rollup of one fleet run."""

    jobs: Dict[str, JobMetrics]
    fleet: FleetMetrics


class FleetRunner:
    """Runs one ``WorkloadTrace`` under one deployment strategy."""

    def __init__(
        self,
        sim: Simulator,
        cluster: Cluster,
        estimator: AggregationEstimator,
        trace: WorkloadTrace,
        *,
        strategy: Union[str, PolicyConfig] = "jit",
        seed: int = 0,
        round_gap_s: float = 1.0,
        priority_policy: str = "deadline",
        recorder: Optional[ArrivalRecorder] = None,
        on_round: Optional[Callable[[str, int, float], None]] = None,
        on_job_complete: Optional[Callable[[str], None]] = None,
        rng: str = "pcg64",
        vectorized: Optional[bool] = None,
        class_rank_of: Optional[Dict[str, int]] = None,
    ):
        self.sim = sim
        self.cluster = cluster
        self.est = estimator
        self.trace = trace
        self.seed = seed
        # rng="philox" switches the synthetic parties to counter-based
        # per-party streams (repro.fleet.streams) and, by default, turns on
        # the vectorized scheduler-vehicle fast path: one presampled round
        # per job fed to JITScheduler.begin_round_presampled instead of one
        # simulator event per party-arrival. pcg64 (the default) keeps the
        # original sequential streams — existing traces stay bit-identical.
        if rng not in ("pcg64", "philox"):
            raise ValueError(
                f"unknown fleet rng {rng!r}: expected 'pcg64' or 'philox'")
        if vectorized is None:
            vectorized = rng == "philox"
        if vectorized and rng != "philox":
            raise ValueError(
                "vectorized fleet sampling needs rng='philox' "
                "(pcg64 streams are sequential and cannot be batched)")
        self.rng = rng
        self.vectorized = vectorized
        self._samplers: Dict[str, object] = {}  # philox grids per job
        # conformance hook: every (job, party, round) availability sample is
        # reported in the same order on BOTH vehicles (repro.fleet.conformance)
        self.recorder = recorder
        # streaming hooks (repro.online): fired per completed round
        # (job_id, round_idx, completion_t) and once per completed job
        self.on_round = on_round
        self.on_job_complete = on_job_complete
        # SLA-class ranks (repro.online): job_id -> rank carried into every
        # pool task this job submits, so task priority on the shared cluster
        # is (class_rank, deadline). Missing/None = rank 0 (single class),
        # which keeps batch traces bit-identical to the unranked code.
        self.class_rank_of: Dict[str, int] = dict(class_rank_of or {})
        # the scheduler vehicle handles the bare name "jit"; anything else
        # (including an explicit PolicyConfig, even strategy="jit") runs on
        # per-job RoundEngines over the same cluster
        self.use_scheduler = strategy == "jit"
        self.policy = None if self.use_scheduler else as_policy(strategy)
        if self.policy is not None:
            get_strategy(self.policy.strategy)  # fail fast on unknown names
        self.strategy_name = "jit" if self.use_scheduler \
            else self.policy.strategy
        self.scheduler: Optional[JITScheduler] = None
        if self.use_scheduler:
            self.scheduler = JITScheduler(
                sim, cluster, estimator,
                priority_policy=priority_policy,
                auto_restart=True,
                round_gap_s=round_gap_s,
                on_round_start=self._on_sched_round_start,
                on_aggregated=self._on_sched_aggregated,
            )
        self.specs: Dict[str, FLJobSpec] = {}
        self.parties: Dict[str, Dict[str, object]] = {}
        self.engines: Dict[str, RoundEngine] = {}
        self.completed: Set[str] = set()
        # validate the WHOLE trace before scheduling anything: a partial
        # schedule followed by a raise would leave phantom jobs billing
        # the shared cluster
        self._ids: Set[str] = set()
        for jt in trace.jobs:
            if jt.job_id in self._ids:
                raise ValueError(
                    f"duplicate job id {jt.job_id!r} in trace {trace.name!r}")
            self._ids.add(jt.job_id)
        # grows with submit_job (online admission past the batch trace)
        self._n_expected = trace.n_jobs
        for jt in trace.jobs:
            self.sim.schedule_at(
                jt.submit_s, lambda jt=jt: self._submit(jt))

    @property
    def all_done(self) -> bool:
        return self.completed == set(self.specs) and (
            len(self.specs) == self._n_expected)

    # ---- job submission ----------------------------------------------------
    def submit_job(self, jt: JobTrace, class_rank: int = 0) -> None:
        """Admit one more job into the running fleet NOW (at ``sim.now``).

        This is the open-loop path (``repro.online``): batch traces
        pre-schedule every job at construction, an online controller admits
        jobs as its arrival stream produces them. The job joins the same
        shared cluster/scheduler and counts toward ``all_done``.
        ``class_rank`` is the job's SLA-class rank (0 = gold): every pool
        task the job submits carries it, making task priority
        (class_rank, deadline) under §5.5 preemption."""
        if jt.job_id in self._ids:
            raise ValueError(
                f"duplicate job id {jt.job_id!r} in fleet {self.trace.name!r}")
        self._ids.add(jt.job_id)
        self._n_expected += 1
        if class_rank:
            self.class_rank_of[jt.job_id] = class_rank
        self._submit(jt)

    def _submit(self, jt: JobTrace) -> None:
        spec = jt.to_jobspec()
        self.specs[spec.job_id] = spec
        parties, sampler = build_party_processes(jt, self.seed, self.rng)
        self.parties[spec.job_id] = parties
        if sampler is not None:
            self._samplers[spec.job_id] = sampler
        rank = self.class_rank_of.get(spec.job_id, 0)
        if self.use_scheduler:
            predictor = None
            if self.vectorized and sampler is not None:
                # array-backed predictor, fed one whole round at a time by
                # begin_round_presampled (measured jobs keep the scalar one)
                predictor = VectorizedUpdatePredictor(spec)
            self.scheduler.upon_arrival(spec, gated=True,
                                        predictor=predictor,
                                        class_rank=rank)
            self.scheduler.start_round(spec.job_id)
            return
        # MeasuredParty processes replay measured jobs through the same
        # source adapter the synthetic parties use
        engine = RoundEngine(
            self.sim, self.cluster, spec, self.est, self.policy,
            class_rank=rank,
            arrival_model=FleetArrivalSource(
                self.sim, self.parties[spec.job_id],
                job_id=spec.job_id, recorder=self.recorder),
            on_round_complete=(
                None if self.on_round is None
                else lambda r, t, j=spec.job_id: self.on_round(j, r, t)),
            on_job_done=lambda j=spec.job_id: self._job_complete(j),
        )
        self.engines[spec.job_id] = engine
        engine.start()

    # ---- scheduler-vehicle hooks -------------------------------------------
    def _on_sched_round_start(self, job_id: str, round_idx: int) -> None:
        """A gated round began: sample every party's availability, schedule
        the arrivals as simulator events, report the no-shows.

        On the vectorized path the round comes out of the job's presampled
        philox grid as arrays and goes to ``begin_round_presampled`` whole —
        no per-arrival events. The recorder still sees every (party, round)
        sample in party order, same as the scalar loop below and the engine
        vehicle, so conformance arrival logs stay comparable."""
        sched = self.scheduler
        sampler = self._samplers.get(job_id) if self.vectorized else None
        if sampler is not None:
            train, comm, noshow = sampler.round_view(round_idx)
            if self.recorder is not None:
                for i, pid in enumerate(sampler.party_ids):
                    self.recorder(
                        job_id, pid, round_idx,
                        None if noshow[i]
                        else (float(train[i]), float(comm[i])))
            idx = np.nonzero(~noshow)[0]
            t_train = train[idx]
            times = self.sim.now + t_train + comm[idx]
            order = np.argsort(times, kind="stable")
            sched.begin_round_presampled(
                job_id, times[order], idx, t_train,
                int(noshow.sum()))
            return
        arrivals = []
        no_shows = 0
        for pid, party in self.parties[job_id].items():
            rec = party.sample_round(round_idx, self.sim.now)
            if self.recorder is not None:
                self.recorder(job_id, pid, round_idx, rec)
            if rec is None:
                no_shows += 1
            else:
                arrivals.append((pid, rec))
        for pid, (train, comm) in arrivals:
            self.sim.schedule(
                train + comm,
                lambda j=job_id, p=pid, t=train: sched.deliver_update(j, p, t))
        for _ in range(no_shows):
            sched.party_no_show(job_id)

    def _on_sched_aggregated(self, job_id: str, round_idx: int,
                             t: float) -> None:
        if self.on_round is not None:
            self.on_round(job_id, round_idx, t)
        if round_idx + 1 >= self.specs[job_id].rounds:
            self._job_complete(job_id)

    def _job_complete(self, job_id: str) -> None:
        self.completed.add(job_id)
        if self.on_job_complete is not None:
            self.on_job_complete(job_id)

    # ---- metrics -----------------------------------------------------------
    def metrics(self) -> Dict[str, JobMetrics]:
        """Per-job §6.2 metrics (billing read live from the cluster), via
        the same builders the ``Platform`` vehicles use
        (``JobState.to_metrics`` / ``RoundEngine.billed_metrics``)."""
        price = self.cluster.cfg.price_per_container_s
        out: Dict[str, JobMetrics] = {}
        for job_id in self.specs:
            if self.use_scheduler:
                out[job_id] = self.scheduler.jobs[job_id].to_metrics(
                    self.cluster, price)
            else:
                out[job_id] = self.engines[job_id].billed_metrics(price)
        return out

    def result(self, *, timeline_bins: int = 50) -> FleetResult:
        """Per-job metrics + fleet rollup. The rollup's preemption count,
        utilization and timeline are cluster-wide — run one fleet per
        Platform for clean numbers.

        Partial runs (``Platform.run(until=...)`` stopping the clock before
        the fleet drains) are well-defined on both vehicles: only jobs whose
        trace ``submit_s`` has passed appear at all, each reports only the
        rounds it actually completed by the cutoff, and billing is what the
        cluster actually charged so far — including the accrued-but-unbilled
        time of live always-on / streaming containers
        (``RoundEngine.billed_metrics``). Unstarted jobs are never mixed in
        and nothing raises; check ``all_done`` to distinguish a drained
        fleet from a cutoff one."""
        jobs = self.metrics()
        fleet = fleet_rollup(
            jobs,
            capacity=self.cluster.cfg.capacity,
            makespan_s=self.sim.now,
            n_preemptions=self.cluster.n_preemptions,
            occupancy_events=self.cluster.occupancy_events,
            price_per_container_s=self.cluster.cfg.price_per_container_s,
            timeline_bins=timeline_bins,
        )
        return FleetResult(jobs=jobs, fleet=fleet)
