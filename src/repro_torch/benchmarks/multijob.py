"""Beyond-paper: quantitative evaluation of §5.5 multi-job scheduling.

The paper *describes* priorities (= t_rnd − t_agg) + deadline timers +
preemption for many concurrent FL jobs on one cluster, but only evaluates
single jobs. Here K concurrent jobs with staggered deadlines share a
capacity-constrained cluster; we compare the paper's deadline priorities
(EDF-like) against a FIFO baseline at equal deferral.

Metric: SLA lateness = completion − (round_start + t_rnd) per round —
the time the fused model is late relative to the predicted round end —
plus preemption counts and cluster utilisation.

CSV: policy,capacity,n_jobs,mean_lateness_s,p95_lateness_s,miss_rate,
     preemptions,utilisation
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.api import Platform
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.jobspec import FLJobSpec, PartySpec


def make_job(job_id: str, n_parties: int, epoch_s: float, model_mb: int,
             rounds: int, seed: int) -> FLJobSpec:
    rng = np.random.default_rng(seed)
    parties = {
        f"{job_id}-p{i}": PartySpec(
            f"{job_id}-p{i}",
            epoch_time_s=float(epoch_s * rng.uniform(0.9, 1.3)),
            dataset_size=1000,
        )
        for i in range(n_parties)
    }
    return FLJobSpec(job_id=job_id, model_arch="x",
                     model_bytes=model_mb << 20, rounds=rounds,
                     parties=parties)


def simulate(policy: str, capacity: int, n_jobs: int, seed: int = 0):
    platform = Platform(
        ClusterConfig(capacity=capacity, delta_s=1.0, deploy_overhead_s=0.5,
                      state_load_s=0.2, checkpoint_s=0.2),
        AggregationEstimator(t_pair_s=0.3),
    )
    rng = np.random.default_rng(seed)

    jobs = []
    for k in range(n_jobs):
        # mixed fleet: short-deadline small jobs + long-deadline big jobs
        if k % 3 == 0:
            j = make_job(f"small{k}", 20, float(rng.uniform(40, 80)), 50, 6,
                         seed + k)
        elif k % 3 == 1:
            j = make_job(f"medium{k}", 100, float(rng.uniform(150, 400)),
                         200, 4, seed + k)
        else:
            j = make_job(f"big{k}", 300, float(rng.uniform(500, 1000)), 500,
                         2, seed + k)
        jobs.append(j)

    for j in jobs:
        platform.submit_scheduled(j, priority_policy=policy, round_gap_s=1.0)
    metrics = platform.run()

    lat = np.concatenate([metrics[j.job_id].round_lateness for j in jobs])
    total_rounds = sum(j.rounds for j in jobs)
    assert len(lat) == total_rounds, (len(lat), total_rounds)
    makespan = platform.sim.now
    cluster = platform.cluster
    util = cluster.container_seconds / (capacity * makespan) if makespan else 0
    return {
        "policy": policy,
        "capacity": capacity,
        "n_jobs": n_jobs,
        "mean_lateness_s": float(np.mean(lat)),
        "p95_lateness_s": float(np.percentile(lat, 95)),
        # miss = fused model later than 60s past the predicted round end
        "miss_rate": float(np.mean(lat > 60.0)),
        "preemptions": cluster.n_preemptions,
        "utilisation": round(util, 3),
    }


def run(full: bool = False):
    rows = []
    for n_jobs in [6, 12] + ([24] if full else []):
        for capacity in [1, 2, 4]:
            for policy in ["fifo", "deadline"]:
                r = simulate(policy, capacity, n_jobs)
                rows.append(r)
                print(",".join(str(v) if not isinstance(v, float)
                               else f"{v:.2f}" for v in r.values()),
                      flush=True)
    return rows


def main():
    print("policy,capacity,n_jobs,mean_lateness_s,p95_lateness_s,miss_rate,"
          "preemptions,utilisation")
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
