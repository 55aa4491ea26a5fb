"""Paper Figs. 7 & 8: aggregation latency (s) vs number of parties, for
heterogeneous intermittent (Fig. 7) and heterogeneous active (Fig. 8)
parties, across the aggregation strategies.

CSV: figure,workload,participation,n_parties,strategy,mean_latency_s,p95_s
"""
from __future__ import annotations

import sys

from repro_torch.benchmarks.workloads import WORKLOADS, build_job
from repro_torch.api import run_job
from repro_torch.core import PolicyConfig

PARTY_COUNTS = [10, 100, 1000]
STRATS = ["eager_ao", "eager_serverless", "batched", "jit"]


def batch_trigger_for(n: int) -> int:
    # paper §6.3: batches of (2,10,100,100) for (10,100,1000,10000) parties
    return {10: 2, 100: 10, 1000: 100, 10000: 100}[n]


def run(full: bool = False, rounds: int = 20, *, counts=None,
        workloads=None, figures=None):
    """Full CLI grid by default; the keyword filters let the golden smoke
    tests lock one tiny cell of the grid without running the rest."""
    if counts is None:
        counts = PARTY_COUNTS + ([10000] if full else [])
    if figures is None:
        figures = [("fig7", "intermittent-hetero"),
                   ("fig8", "active-hetero")]
    rows = []
    for wl in (WORKLOADS if workloads is None else workloads):
        for fig, part in figures:
            for n in counts:
                for s in STRATS:
                    job = build_job(wl, n, part, rounds=rounds)
                    m = run_job(
                        job,
                        PolicyConfig(strategy=s,
                                     batch_trigger=batch_trigger_for(n)),
                        t_pair_s=wl.t_pair_s,
                        cluster_config=wl.cluster_config(),
                        noise_rel=0.05,
                    )
                    rows.append((fig, wl.name, part, n, s,
                                 m.mean_latency, m.p95_latency))
                    print(f"{fig},{wl.name},{part},{n},{s},"
                          f"{m.mean_latency:.3f},{m.p95_latency:.3f}",
                          flush=True)
    return rows


def main():
    print("figure,workload,participation,n_parties,strategy,"
          "mean_latency_s,p95_latency_s")
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
