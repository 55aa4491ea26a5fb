"""Multi-tenant JIT scheduling (§5.5) through the `Platform` facade: many
concurrent FL jobs share one Kubernetes-like cluster. Demonstrates
priorities (= deadline t_rnd - t_agg), the deadline timer, opportunistic
early aggregation on idle capacity, and preemption with partial-aggregate
checkpointing.

  PYTHONPATH=src python -m repro_torch.examples.multijob_scheduler

The port of ``examples/multijob_scheduler.py``. It runs on the virtual
clock alone and uses no device, so it takes no ``--device``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.api import Platform
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.metrics import JobMetrics


def make_job(job_id: str, n_parties: int, epoch_s: float, model_mb: int,
             rounds: int, seed: int) -> FLJobSpec:
    rng = np.random.default_rng(seed)
    parties = {
        f"{job_id}-p{i}": PartySpec(
            f"{job_id}-p{i}",
            epoch_time_s=float(epoch_s * rng.uniform(0.9, 1.4)),
            dataset_size=1000,
        )
        for i in range(n_parties)
    }
    return FLJobSpec(job_id=job_id, model_arch="x",
                     model_bytes=model_mb << 20, rounds=rounds,
                     parties=parties)


def main() -> Tuple[Platform, Dict[str, JobMetrics]]:
    """Run the three contending jobs and print the reference's report;
    returns the platform and its metrics by job."""
    # a deliberately SMALL cluster so jobs contend (capacity 2)
    platform = Platform(ClusterConfig(capacity=2, delta_s=1.0),
                        AggregationEstimator(t_pair_s=0.3))
    cluster = platform.cluster

    jobs = [
        make_job("small-fast", n_parties=20, epoch_s=60, model_mb=50,
                 rounds=6, seed=1),
        make_job("medium", n_parties=100, epoch_s=300, model_mb=200,
                 rounds=4, seed=2),
        make_job("big-slow", n_parties=400, epoch_s=900, model_mb=500,
                 rounds=2, seed=3),
    ]

    def on_aggregated(job_id, round_idx, t):
        print(f"[t={t:8.1f}s] {job_id:12s} round {round_idx} aggregated "
              f"(cluster: {len(cluster.running)} running, "
              f"{len(cluster.pending)} pending, "
              f"{cluster.n_preemptions} preemptions so far)")

    # rounds restart automatically 1s after each fused model (round_gap_s)
    for j in jobs:
        st = platform.submit_scheduled(j, on_aggregated=on_aggregated,
                                       round_gap_s=1.0)
        print(f"job {j.job_id:12s}: {j.n_parties:4d} parties  "
              f"t_rnd={st.t_rnd:8.1f}s  t_agg={st.t_agg:6.1f}s  "
              f"priority(deadline)={st.t_rnd - st.t_agg:8.1f}s")

    metrics = platform.run()

    print("\n--- summary ---")
    total_rounds = sum(m.rounds_done for m in metrics.values())
    print(f"rounds aggregated: {total_rounds}")
    print(f"deployments: {cluster.n_deploys}, "
          f"preemptions: {cluster.n_preemptions}")
    print(f"container-seconds by job: "
          f"{ {k: round(m.container_seconds, 1) for k, m in metrics.items()} }")
    sim_now = platform.sim.now
    print(f"total container-seconds: {cluster.container_seconds:.1f} "
          f"over {sim_now:.1f}s of cluster time")
    util = cluster.container_seconds / (2 * sim_now)
    print(f"cluster utilisation: {100*util:.1f}% "
          f"(vs 3 always-on aggregators = {100*3*sim_now/(2*sim_now):.0f}% "
          f"of capacity demanded)")
    return platform, metrics


if __name__ == "__main__":
    main()
