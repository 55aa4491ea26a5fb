"""`repro_torch.api` — the platform surface of the port.

    from repro_torch.api import Platform, replay_measured

    # real federated training (parties + CUDA fusion kernels), priced under
    # any registered strategy via the measured-arrival replay
    result = Platform().train(model_cfg, job)           # -> TrainingResult
    ao = replay_measured(job, result.runtime.measured_rounds, "eager_ao")

``replay_measured`` re-prices one real run's recorded arrivals under any
registered policy without retraining.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.cluster import Cluster, ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import JobMetrics
from repro_torch.core.policy import PolicyConfig, as_replay_policy
from repro_torch.core.strategies import MeasuredArrivals, RoundEngine
from repro_torch.fl.job import FLJobRuntime, RoundRecord

__all__ = ["Platform", "TrainingResult", "replay_measured"]


@dataclasses.dataclass
class TrainingResult:
    """Outcome of the real-training vehicle (``Platform.train``)."""

    metrics: JobMetrics
    records: List[RoundRecord]
    runtime: FLJobRuntime  # final params, eval_loss, measured_rounds, ...


class Platform:
    """A cluster configuration and an estimator that price real training."""

    def __init__(
        self,
        cluster_config: Optional[ClusterConfig] = None,
        estimator: Optional[AggregationEstimator] = None,
        *,
        t_pair_s: float = 0.05,
    ):
        self.cluster_config = cluster_config or ClusterConfig()
        self._estimator_explicit = estimator is not None
        self.estimator = estimator or AggregationEstimator(t_pair_s)

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
    single real training run can be costed under every deployment policy.
    The default policy is the deterministic JIT timeline
    (``jit_policy="fixed"``). With ``single_worker_fuse`` (default) the
    per-update fuse cost is the raw measured t_pair, matching the real
    runtime's streaming aggregator. A passed estimator is copied.
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
