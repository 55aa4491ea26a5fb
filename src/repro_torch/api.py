"""`repro_torch.api` — the platform surface of the port: one facade over the
three execution vehicles.

    from repro_torch.api import Platform, replay_measured
    from repro_torch.core import ClusterConfig, PolicyConfig

    platform = Platform(ClusterConfig(), t_pair_s=0.08)

    # 1. single- or many-job discrete-event simulation
    platform.submit(job, PolicyConfig(strategy="jit", opportunistic=True))
    metrics = platform.run()[job.job_id]          # -> JobMetrics

    # 2. multi-job Fig. 6 scheduler contention (EDF priorities, preemption)
    platform.submit_scheduled(job_a)
    platform.submit_scheduled(job_b)
    metrics = platform.run()                      # -> {job_id: JobMetrics}

    # 2b. fleet-scale trace-driven simulation with per-job simulated parties
    runner = platform.submit_fleet(synthetic_fleet(16), strategy="jit")
    platform.run()
    rollup = runner.result().fleet                # -> FleetMetrics

    # 2c. long-lived online service over an unbounded arrival stream
    svc = platform.serve(TraceStream(trace, timing="poisson"), sla="gold")
    report = svc.drain()                          # -> OnlineReport

    # 3. real federated training (parties + CUDA fusion kernels), priced
    #    under any registered strategy via the measured-arrival replay
    result = Platform().train(model_cfg, job)           # -> TrainingResult
    ao = replay_measured(job, result.runtime.measured_rounds, "eager_ao")

The simulation vehicles (1, 2, 2b, 2c) run on the host's virtual clock and
take no device. ``Platform(cost_table=...)`` prices their fuse work from a
``repro_torch.kernels.autotune.KernelCostTable`` measured on the card.
Real training (3) runs on the card unless the caller names another device.
``replay_measured`` re-prices one real run's recorded arrivals under any
registered policy without retraining; ``run_job`` is the one-shot
simulation (fresh simulator + cluster per call).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.cluster import Cluster, ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import JobMetrics
from repro_torch.core.policy import PolicyConfig, as_policy, as_replay_policy
from repro_torch.core.scheduler import JITScheduler, JobState
from repro_torch.core.strategies import (
    ArrivalModel, MeasuredArrivals, RoundEngine)
from repro_torch.fl.job import FLJobRuntime, RoundRecord

__all__ = ["Platform", "TrainingResult", "replay_measured", "run_job"]


@dataclasses.dataclass
class TrainingResult:
    """Outcome of the real-training vehicle (``Platform.train``)."""

    metrics: JobMetrics
    records: List[RoundRecord]
    runtime: FLJobRuntime  # final params, eval_loss, measured_rounds, ...


class Platform:
    """One shared simulated cluster + estimator, three execution vehicles."""

    def __init__(
        self,
        cluster_config: Optional[ClusterConfig] = None,
        estimator: Optional[AggregationEstimator] = None,
        *,
        t_pair_s: float = 0.05,
        cost_table=None,
        tracer=None,
    ):
        self.sim = Simulator()
        self.cluster_config = cluster_config or ClusterConfig()
        # sim-time tracing (repro_torch.obs): pass a ``Tracer`` to record
        # spans/events from every vehicle sharing this cluster; the default
        # is the free no-op singleton (goldens bit-identical)
        self.cluster = Cluster(self.sim, self.cluster_config, tracer=tracer)
        self.tracer = self.cluster.tracer
        self._estimator_explicit = estimator is not None
        # cost_table: a measured `repro_torch.kernels.autotune.KernelCostTable`;
        # when supplied, every vehicle prices t_pair/t_agg from measured
        # kernel timings per model size instead of the t_pair_s constant
        self.estimator = estimator or AggregationEstimator(
            t_pair_s, cost_table=cost_table)
        if cost_table is not None and estimator is not None:
            self.estimator = dataclasses.replace(
                estimator, cost_table=cost_table)
        self.engines: Dict[str, RoundEngine] = {}
        self._scheduler: Optional[JITScheduler] = None
        self._fleets: List[Any] = []  # List[repro_torch.fleet.FleetRunner]
        self._fleet_job_ids: set = set()
        self._services: List[Any] = []  # List[repro_torch.online.OnlineController]
        self._ran = False

    # ---- vehicle 1: per-job simulation engines -----------------------------
    def submit(
        self,
        job: FLJobSpec,
        policy: Union[PolicyConfig, str, None] = None,
        *,
        seed: int = 0,
        noise_rel: float = 0.02,
        dropout_prob: float = 0.0,
        arrival_model: Optional[ArrivalModel] = None,
        on_round_complete=None,
        external_arrivals: bool = False,
        gated_rounds: bool = False,
    ) -> RoundEngine:
        """Queue `job` for simulation under `policy`; returns its engine.

        Many jobs may be submitted before ``run()``; they share the
        platform's cluster and contend for its capacity.
        """
        policy = as_policy(policy)
        self._check_new(job.job_id)
        engine = RoundEngine(
            self.sim, self.cluster, job, self.estimator, policy,
            arrival_model=arrival_model or ArrivalModel(
                job, noise_rel=noise_rel, seed=seed,
                dropout_prob=dropout_prob,
            ),
            on_round_complete=on_round_complete,
            external_arrivals=external_arrivals,
            gated_rounds=gated_rounds,
        )
        self.engines[job.job_id] = engine
        return engine

    # ---- vehicle 2: multi-job Fig. 6 scheduler -----------------------------
    def scheduler(
        self,
        *,
        priority_policy: Optional[str] = None,
        round_gap_s: Optional[float] = None,
        on_aggregated=None,
    ) -> JITScheduler:
        """The platform's (lazily created) multi-job JIT scheduler.

        Scheduler settings are platform-wide: the first call fixes them
        (defaults: "deadline" priorities, 1s round gap); a later call
        passing a conflicting value raises instead of silently ignoring it.
        """
        if self._scheduler is None:
            self._scheduler = JITScheduler(
                self.sim, self.cluster, self.estimator,
                on_aggregated=on_aggregated,
                priority_policy=priority_policy or "deadline",
                auto_restart=True,
                round_gap_s=1.0 if round_gap_s is None else round_gap_s,
            )
            return self._scheduler
        sched = self._scheduler
        for name, want, have in [
            ("priority_policy", priority_policy, sched.priority_policy),
            ("round_gap_s", round_gap_s, sched.round_gap_s),
            ("on_aggregated", on_aggregated, sched.on_aggregated),
        ]:
            if want is not None and want != have:
                raise ValueError(
                    f"scheduler already created with {name}={have!r}; "
                    f"cannot change it to {want!r} (one scheduler per "
                    f"Platform)")
        return sched

    def submit_scheduled(self, job: FLJobSpec, **scheduler_kw) -> JobState:
        """Queue `job` on the shared Fig. 6 JIT scheduler (§5.5 contention:
        EDF priorities, deadline timers, preemption). Rounds restart
        automatically until ``job.rounds`` complete."""
        self._check_new(job.job_id)
        return self.scheduler(**scheduler_kw).upon_arrival(job)

    # ---- vehicle 2b: trace-driven fleet with simulated parties -------------
    def submit_fleet(
        self,
        trace,
        strategy="jit",
        *,
        seed: int = 0,
        round_gap_s: float = 1.0,
        priority_policy: str = "deadline",
        recorder=None,
        rng: str = "pcg64",
        vectorized: Optional[bool] = None,
        class_rank_of: Optional[Dict[str, int]] = None,
    ):
        """Queue a ``repro_torch.fleet.WorkloadTrace`` on this platform's cluster;
        returns the ``FleetRunner`` (read ``runner.result()`` after
        ``run()``).

        ``class_rank_of`` maps job_id -> SLA-class rank (0 = gold, larger =
        lower class); every pool task a ranked job submits carries the rank,
        so shared-cluster task priority is (class_rank, deadline) and gold
        drains preempt running best_effort drains (§5.5). Unlisted jobs are
        rank 0 — a trace with no map behaves exactly as before.

        ``rng`` selects the synthetic parties' stream scheme: ``"pcg64"``
        (default) is the original sequential per-party stream — existing
        traces and goldens stay bit-identical; ``"philox"`` presamples each
        job on counter-based per-party streams and (``vectorized``, on by
        default for philox) drives the scheduler vehicle through the
        batched fast path — one calendar trigger per job round instead of
        one event per party arrival (the fleet-at-scale mode, see
        ``benchmarks/simcore.py``). The paired per-party-stream guarantee
        holds within either scheme; the two schemes draw different (equally
        valid) arrival sequences.

        ``recorder``, if given, is called once per (job, party, round) with
        the sampled availability — ``None`` on a §2.2 no-show, else
        ``(train_s, comm_s)`` — on either vehicle, in per-party round
        order; the cross-vehicle conformance harness
        (``repro_torch.fleet.conformance``) uses it to assert that paired runs
        saw identical arrival sequences.

        ``strategy="jit"`` drives the Fig. 6 multi-job scheduler in
        arrival-gated mode — per-job simulated parties deliver update
        events, the predictor calibrates t_rnd online from them, and the
        scheduler vehicle observes true §6.2 aggregation latency. Any other
        registered strategy name (or an explicit ``PolicyConfig``) runs the
        per-job engine baselines (eager-AO, eager-λ, ...) over the SAME
        arrival sequences for paired comparisons. Jobs are submitted at
        their trace ``submit_s`` times once ``run()`` starts the clock.
        """
        from repro_torch.fleet.fleet import FleetRunner  # deferred: repro_torch.fleet

        if self._ran:
            raise RuntimeError(
                "Platform.run() already called; build a new Platform "
                "(simulated clusters are single-shot)")
        # job ids must be unique across ALL vehicles sharing this cluster:
        # a collision would silently merge per-job billing and overwrite
        # metrics rows (compare strategies on fresh Platforms instead)
        for jt in trace.jobs:
            self._check_new(jt.job_id)
        runner = FleetRunner(
            self.sim, self.cluster, self.estimator, trace,
            strategy=strategy, seed=seed, round_gap_s=round_gap_s,
            priority_policy=priority_policy, recorder=recorder,
            rng=rng, vectorized=vectorized, class_rank_of=class_rank_of,
        )
        self._fleets.append(runner)
        self._fleet_job_ids.update(jt.job_id for jt in trace.jobs)
        return runner

    # ---- vehicle 2c: the online control plane (long-lived service) ---------
    def serve(
        self,
        stream,
        *,
        strategy="jit",
        sla=None,
        sla_classes=None,
        autoscaler=None,
        admission=None,
        window_s: float = 600.0,
        seed: int = 0,
        round_gap_s: float = 1.0,
        priority_policy: str = "deadline",
        recorder=None,
        trace=None,
    ):
        """Run the Platform as a long-lived service consuming an unbounded
        ``repro_torch.online.ArrivalStream`` instead of a pre-drained trace;
        returns the ``OnlineController``.

            from repro_torch.online import TraceStream
            svc = platform.serve(TraceStream(trace), sla="gold")
            svc.advance(until=3600.0)     # repeatable, unlike Platform.run
            windows = svc.poll()          # completed metric windows so far
            report = svc.drain()          # to quiescence -> OnlineReport

        ``sla`` assigns each arriving job an SLA class (``None`` = all
        ``gold``: admit everything, which makes ``serve`` on a
        ``TraceStream(trace)`` arrival-identical to ``submit_fleet(trace)``
        — the paired-comparison guarantee). Pass a class name, a
        ``{job_id: class}`` dict, or a ``(job_trace, arrival_index) ->
        class`` callable; classes default to ``repro_torch.online.SLA_CLASSES``
        (gold admits, silver queues under burst, best_effort sheds).

        ``autoscaler`` (``AutoscalerConfig``) resizes the aggregator pool
        against queue depth + drain backlog with hysteresis
        (``AutoscalerConfig.fixed(n)`` pins it); ``admission``
        (``AdmissionConfig``) sets the burst window/threshold and queue
        size. Windowed metrics tumble every ``window_s`` and are pollable
        mid-run via ``svc.poll()``.

        The service drives the same shared cluster as every other vehicle;
        job ids arriving on the stream must be fleet-unique (checked at
        admission time). Drive with ``svc.advance``/``svc.drain`` — or
        ``platform.run(until=...)``, which also starts any batch work
        submitted alongside.

        ``trace`` installs a ``repro_torch.obs.Tracer`` on the shared cluster
        before the controller is built, so admission/autoscale decisions,
        scheduler rounds and container billing are all recorded
        (``svc.dashboard()`` then includes a metrics snapshot, and
        ``trace.export_chrome(path)`` writes a Perfetto-loadable artifact).
        """
        from repro_torch.online.controller import OnlineController  # deferred

        if self._ran:
            raise RuntimeError(
                "Platform.run() already called; build a new Platform "
                "(simulated clusters are single-shot)")
        if trace is not None:
            # install before dependents capture cluster.tracer at init
            self.tracer = trace
            self.cluster.tracer = trace
        svc = OnlineController(
            self.sim, self.cluster, self.estimator, stream,
            strategy=strategy, sla=sla, sla_classes=sla_classes,
            autoscaler=autoscaler, admission=admission, window_s=window_s,
            seed=seed, round_gap_s=round_gap_s,
            priority_policy=priority_policy, recorder=recorder,
            on_admitted=self._register_online_job,
        )
        # the service's runner joins the fleet list so Platform.metrics()
        # includes online jobs alongside the batch vehicles
        self._fleets.append(svc.runner)
        self._services.append(svc)
        return svc

    def _register_online_job(self, job_id: str) -> None:
        """Admission-time collision check: stream jobs must not collide
        with ids on any other vehicle sharing this cluster (a collision
        would merge per-job billing)."""
        if job_id in self.engines or (
            self._scheduler is not None and job_id in self._scheduler.jobs
        ):
            raise ValueError(
                f"online job {job_id!r} collides with a job already "
                f"submitted on another vehicle of this Platform")
        self._fleet_job_ids.add(job_id)

    # ---- run ---------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> Dict[str, JobMetrics]:
        """Start everything submitted, run the clock, return metrics by job."""
        if self._ran:
            raise RuntimeError(
                "Platform.run() already called; build a new Platform "
                "(simulated clusters are single-shot)")
        self._ran = True
        for engine in self.engines.values():
            engine.start()
        if self._scheduler is not None:
            for job_id in self._scheduler.jobs:
                self._scheduler.start_round(job_id)
        self.sim.run(until)
        return self.metrics()

    def metrics(self) -> Dict[str, JobMetrics]:
        out: Dict[str, JobMetrics] = {}
        price = self.cluster_config.price_per_container_s
        for job_id, engine in self.engines.items():
            out[job_id] = engine.billed_metrics(price)
        if self._scheduler is not None:
            for st in self._scheduler.jobs.values():
                out[st.job.job_id] = st.to_metrics(self.cluster, price)
        for runner in self._fleets:
            out.update(runner.metrics())
        return out

    # ---- vehicle 3: real federated training on the card -------------------
    def train(
        self,
        model_cfg,
        job: FLJobSpec,
        policy: Union[PolicyConfig, str, None] = None,
        *,
        rounds: Optional[int] = None,
        verbose: bool = False,
        **runtime_kw: Any,
    ) -> TrainingResult:
        """Run real federated training (parties + fusion kernels) for `job`
        on `model_cfg`, priced under `policy`'s deployment strategy on a
        virtual clock driven by the measured arrivals.

        None and the bare name "jit" select the deterministic JIT timeline
        (``PolicyConfig(strategy="jit", jit_policy="fixed")``).

        `runtime_kw` is forwarded to ``FLJobRuntime`` (n_sequences,
        heterogeneous, seed, epochs_per_round, device, initial_params, ...);
        with no ``device`` the run is on the card. The platform's cluster
        config prices the virtual timeline. The estimator:
        ``runtime_kw["estimator"]`` if given, else a copy of the platform's
        when the platform was built with an explicit one, else §5.4 offline
        measurement on the real fusion kernel.
        """
        runtime_kw.setdefault("cluster_config", self.cluster_config)
        if self._estimator_explicit:
            runtime_kw.setdefault(
                "estimator", dataclasses.replace(self.estimator))
        runtime = FLJobRuntime(model_cfg, job, policy=policy, **runtime_kw)
        records = runtime.run(rounds=rounds, verbose=verbose)
        return TrainingResult(
            metrics=runtime.metrics(), records=records, runtime=runtime,
        )


    # ---- internals ---------------------------------------------------------
    def _check_new(self, job_id: str) -> None:
        if self._ran:
            raise RuntimeError(
                "Platform.run() already called; build a new Platform "
                "(simulated clusters are single-shot)")
        if job_id in self.engines or job_id in self._fleet_job_ids or (
            self._scheduler is not None and job_id in self._scheduler.jobs
        ):
            raise ValueError(f"job {job_id!r} already submitted")


def replay_measured(
    job: FLJobSpec,
    measured_rounds: List[Dict[str, Any]],
    policy: Union[PolicyConfig, str, None] = None,
    *,
    cluster_config: Optional[ClusterConfig] = None,
    estimator: Optional[AggregationEstimator] = None,
    t_pair_s: float = 0.05,
    single_worker_fuse: bool = True,
) -> JobMetrics:
    """Price *measured* per-party arrivals under any registered strategy.

    `measured_rounds` is one dict per round mapping party id to a
    ``(train_s, comm_s)`` pair — exactly what ``FLJobRuntime`` records in
    ``measured_rounds`` — and is replayed on a fresh virtual cluster, so a
    single real training run can be costed under every deployment policy
    (the real-training analogue of ``run_job``). The default policy is the
    deterministic JIT timeline (``jit_policy="fixed"``); pass any
    ``PolicyConfig`` or registered strategy name to compare. With
    ``single_worker_fuse`` (default) the per-update fuse cost is the raw
    measured t_pair, matching the real runtime's streaming aggregator.

    None and the bare name "jit" both select the fixed timeline; pass
    ``PolicyConfig(strategy="jit")`` explicitly for the orderstat
    simulation policy. A passed estimator is copied — the fixed-JIT
    replay's online calibration never leaks back into the caller's.
    """
    if not measured_rounds:
        raise ValueError(
            "replay_measured needs at least one round of measured arrivals")
    policy = as_replay_policy(policy)
    job = dataclasses.replace(job, rounds=len(measured_rounds))
    sim = Simulator()
    cc = cluster_config or ClusterConfig()
    cluster = Cluster(sim, cc)
    est = (dataclasses.replace(estimator) if estimator is not None
           else AggregationEstimator(t_pair_s))
    engine = RoundEngine(
        sim, cluster, job, est, policy,
        arrival_model=MeasuredArrivals(measured_rounds),
        single_worker_fuse=single_worker_fuse,
    )
    engine.start()
    sim.run()
    m = engine.metrics
    m.n_deploys = cluster.n_deploys_by_job.get(job.job_id, 0)
    m.cost_usd = m.container_seconds * cc.price_per_container_s
    return m


def run_job(
    job: FLJobSpec,
    policy: Union[PolicyConfig, str, None] = None,
    *,
    cluster_config: Optional[ClusterConfig] = None,
    estimator: Optional[AggregationEstimator] = None,
    t_pair_s: float = 0.05,
    cost_table=None,
    seed: int = 0,
    noise_rel: float = 0.02,
    dropout_prob: float = 0.0,
) -> JobMetrics:
    """One-shot: simulate `job` under `policy` on a fresh platform."""
    platform = Platform(cluster_config, estimator, t_pair_s=t_pair_s,
                        cost_table=cost_table)
    platform.submit(job, policy, seed=seed, noise_rel=noise_rel,
                    dropout_prob=dropout_prob)
    return platform.run()[job.job_id]
