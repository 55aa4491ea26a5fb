"""Ablation of the JIT scheduling policy (beyond-paper §Perf for the
scheduling layer itself):

  paper      — Fig. 6 literally: fixed timer at t_rnd − t_agg(N), with
               t_rnd = t_wait for intermittent parties; work-conserving
               defer; all-arrived trigger.
  orderstat  — + order-statistic t_rnd for intermittent parties and the
               backlog-fill trigger (deploy when queued work fills the
               time left to the expected last arrival).

Both share the keep-alive economics. Reported per participation mode and
party count: mean aggregation latency and container-seconds per round.

CSV: workload,participation,n_parties,policy,mean_latency_s,cs_per_round
"""
from __future__ import annotations

import sys

from repro_torch.benchmarks.latency import batch_trigger_for
from repro_torch.benchmarks.workloads import WORKLOADS, build_job
from repro_torch.api import run_job
from repro_torch.core import PolicyConfig

PARTY_COUNTS = [10, 100, 1000]
MODES = ["active-hetero", "intermittent-hetero"]


def run(full: bool = False, rounds: int = 20):
    counts = PARTY_COUNTS + ([10000] if full else [])
    wl = WORKLOADS[0]  # EfficientNet-B7 / CIFAR100 (the paper's lead workload)
    rows = []
    for mode in MODES:
        for n in counts:
            for policy in ["paper", "orderstat"]:
                job = build_job(wl, n, mode, rounds=rounds)
                m = run_job(
                    job,
                    PolicyConfig(strategy="jit", jit_policy=policy,
                                 batch_trigger=batch_trigger_for(n)),
                    t_pair_s=wl.t_pair_s,
                    cluster_config=wl.cluster_config(),
                    noise_rel=0.05,
                )
                rows.append((wl.name, mode, n, policy, m.mean_latency,
                             m.container_seconds / rounds))
                print(f"{wl.name},{mode},{n},{policy},"
                      f"{m.mean_latency:.3f},"
                      f"{m.container_seconds / rounds:.2f}", flush=True)
    return rows


def main():
    print("workload,participation,n_parties,policy,mean_latency_s,cs_per_round")
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
