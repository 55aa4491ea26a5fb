"""Paper Fig. 9 (the big table): total container-seconds, projected cost
(Azure ACI $0.0002692 per container-second) and JIT savings percentages, for
all three workloads x participation modes x party counts.

CSV: workload,participation,n_parties,jit_cs,batch_cs,eagerl_cs,ao_cs,
     jit_cost,...,sav_vs_batch,sav_vs_eagerl,sav_vs_ao
"""
from __future__ import annotations

import sys

from repro_torch.benchmarks.latency import batch_trigger_for
from repro_torch.benchmarks.workloads import WORKLOADS, build_job
from repro_torch.api import run_job
from repro_torch.core import PolicyConfig
from repro_torch.core.metrics import AZURE_PRICE_PER_CONTAINER_S, savings

PARTY_COUNTS = [10, 100, 1000]
MODES = ["active-homo", "active-hetero", "intermittent-hetero"]


def run(full: bool = False, rounds: int = 50, *, counts=None,
        workloads=None, modes=None):
    """Full CLI grid by default; the keyword filters let the golden smoke
    tests lock one tiny cell of the grid without running the rest."""
    if counts is None:
        counts = PARTY_COUNTS + ([10000] if full else [])
    rows = []
    for wl in (WORKLOADS if workloads is None else workloads):
        for mode in (MODES if modes is None else modes):
            for n in counts:
                res = {}
                for s in ["jit", "batched", "eager_serverless", "eager_ao"]:
                    job = build_job(wl, n, mode, rounds=rounds)
                    policy = PolicyConfig(
                        strategy=s, batch_trigger=batch_trigger_for(n))
                    res[s] = run_job(
                        job, policy, t_pair_s=wl.t_pair_s,
                        cluster_config=wl.cluster_config(),
                        noise_rel=0.05,
                    )
                cs = {k: v.container_seconds for k, v in res.items()}
                row = dict(
                    workload=wl.name, participation=mode, n_parties=n,
                    jit_cs=round(cs["jit"], 1),
                    batch_cs=round(cs["batched"], 1),
                    eagerl_cs=round(cs["eager_serverless"], 1),
                    ao_cs=round(cs["eager_ao"], 1),
                    jit_cost=round(cs["jit"] * AZURE_PRICE_PER_CONTAINER_S, 4),
                    ao_cost=round(cs["eager_ao"] * AZURE_PRICE_PER_CONTAINER_S,
                                  4),
                    sav_vs_batch=round(savings(res["batched"], res["jit"]), 2),
                    sav_vs_eagerl=round(
                        savings(res["eager_serverless"], res["jit"]), 2),
                    sav_vs_ao=round(savings(res["eager_ao"], res["jit"]), 2),
                )
                rows.append(row)
                print(",".join(str(v) for v in row.values()), flush=True)
    return rows


HEADER = ("workload,participation,n_parties,jit_cs,batch_cs,eagerl_cs,ao_cs,"
          "jit_cost_usd,ao_cost_usd,sav_vs_batch_pct,sav_vs_eagerl_pct,"
          "sav_vs_ao_pct")


def main():
    print(HEADER)
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
