"""Beyond-paper: hierarchical JIT aggregation (edge -> cloud).

The paper's parties are geo-distributed over four datacenters (§6.1) but
all updates stream to one cloud aggregator. Fusion ⊕ is linear, so edge
sites can JIT-aggregate their local parties and forward ONE partial
aggregate; the cloud JIT-aggregates the E edge partials. JIT composes
recursively because an edge aggregate is itself periodic: its completion
time is max(party t_upd) + t_agg_edge, which the cloud's periodicity
tracker learns like any party.

Compared per round against the flat topology (all N parties -> cloud):
  * WAN ingress into the cloud region: N x M -> E x M bytes
  * aggregation container-seconds (edge + cloud vs flat cloud)
  * end-to-end round duration (round start -> fused global model)

CSV: topology,n_parties,n_edges,round_s,cloud_wan_MB_per_round,
     container_s_per_round,cloud_agg_latency_s
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.cluster import Cluster, ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.strategies import ArrivalModel, RoundEngine

JIT = PolicyConfig(strategy="jit")

MODEL_MB = 264  # EfficientNet-B7 update
ROUNDS = 10
WAN_BW = 50e6  # party/edge -> cloud (cross-region)
LAN_BW = 1e9  # party -> edge site (same region)
WAN_USD_PER_GB = 0.08  # inter-region egress (Azure ballpark)
CONTAINER_USD_PER_S = 0.0002692  # paper Fig. 9 pricing


def _parties(n, seed, bw):
    rng = np.random.default_rng(seed)
    return {
        f"p{seed}-{i}": PartySpec(
            f"p{seed}-{i}",
            epoch_time_s=float(np.exp(rng.uniform(np.log(200), np.log(900)))),
            dataset_size=1000, bw_up=bw, bw_down=bw,
        )
        for i in range(n)
    }


def _cc(model_bytes):
    xfer = model_bytes / 1e9
    return ClusterConfig(deploy_overhead_s=0.5, state_load_s=xfer,
                         checkpoint_s=xfer)


def flat(n_parties: int, seed: int = 0):
    mb = MODEL_MB << 20
    sim = Simulator()
    cluster = Cluster(sim, _cc(mb))
    job = FLJobSpec(job_id="flat", model_arch="x", model_bytes=mb,
                    rounds=ROUNDS, parties=_parties(n_parties, 0, WAN_BW))
    run = RoundEngine(sim, cluster, job, AggregationEstimator(3 * mb / 10e9),
                      JIT, arrival_model=ArrivalModel(job, 0.05, seed))
    durations = []
    run.on_round_complete = lambda r, t: durations.append(t - run.round_start)
    run.start()
    sim.run()
    return _row("flat", n_parties, 0, durations,
                n_parties * MODEL_MB, cluster.container_seconds / ROUNDS,
                run.metrics.mean_latency)


def _row(topology, n_parties, n_edges, durations, wan_mb, cs_per_round,
         latency):
    cost = (wan_mb / 1024 * WAN_USD_PER_GB
            + cs_per_round * CONTAINER_USD_PER_S)
    return {
        "topology": topology,
        "n_parties": n_parties,
        "n_edges": n_edges,
        "round_s": float(np.mean(durations)),
        "cloud_wan_MB_per_round": wan_mb,
        "container_s_per_round": cs_per_round,
        "cloud_agg_latency_s": latency,
        "usd_per_round": round(cost, 4),
    }


def hierarchical(n_parties: int, n_edges: int, seed: int = 0):
    mb = MODEL_MB << 20
    per_edge = n_parties // n_edges
    sim = Simulator()
    edge_clusters = [Cluster(sim, _cc(mb)) for _ in range(n_edges)]
    cloud_cluster = Cluster(sim, _cc(mb))
    est = AggregationEstimator(3 * mb / 10e9)

    # cloud job: E pseudo-parties = edge sites; their epoch estimate is the
    # edge's own predicted round end + its aggregation time
    edge_jobs = []
    edge_runs = []
    for e in range(n_edges):
        ps = _parties(per_edge, e + 1, LAN_BW)
        j = FLJobSpec(job_id=f"edge{e}", model_arch="x", model_bytes=mb,
                      rounds=ROUNDS, parties=ps)
        edge_jobs.append(j)

    def edge_eta(j):
        m = max(p.epoch_time_s for p in j.parties.values())
        return m + est.t_agg(j)

    cloud_parties = {
        f"edge{e}": PartySpec(f"edge{e}", epoch_time_s=edge_eta(edge_jobs[e]),
                              dataset_size=per_edge * 1000,
                              bw_up=WAN_BW, bw_down=WAN_BW)
        for e in range(n_edges)
    }
    cloud_job = FLJobSpec(job_id="cloud", model_arch="x", model_bytes=mb,
                          rounds=ROUNDS, parties=cloud_parties)
    cloud = RoundEngine(sim, cloud_cluster, cloud_job, est, JIT,
                        external_arrivals=True)

    durations = []

    def on_cloud_round(r, t):
        durations.append(t - cloud._hier_round_start)
        for er in edge_runs:
            er.release_round()

    cloud.on_round_complete = on_cloud_round

    for e, j in enumerate(edge_jobs):
        run = RoundEngine(
            sim, edge_clusters[e], j, est, JIT,
            arrival_model=ArrivalModel(j, 0.05, seed + e),
            gated_rounds=True,
            on_round_complete=lambda r, t, e=e: sim.schedule(
                mb / WAN_BW, lambda: cloud.inject_update(f"edge{e}")),
        )
        edge_runs.append(run)

    # round bookkeeping: the logical round starts when the edges start
    cloud._hier_round_start = 0.0
    orig_start = cloud._start_round

    def start_round():
        cloud._hier_round_start = min(
            (er.round_start for er in edge_runs), default=sim.now)
        orig_start()

    cloud._start_round = start_round

    for er in edge_runs:
        er.start()
    cloud.start()
    sim.run()

    edge_cs = sum(c.container_seconds for c in edge_clusters)
    return _row(f"hier-{n_edges}e", n_parties, n_edges, durations,
                n_edges * MODEL_MB,
                (edge_cs + cloud_cluster.container_seconds) / ROUNDS,
                cloud.metrics.mean_latency)


def run(full: bool = False):
    rows = []
    for n in [100, 1000] + ([10000] if full else []):
        rows.append(flat(n))
        for e in [4, 16]:
            rows.append(hierarchical(n, e))
    for r in rows:
        print(",".join(f"{v:.2f}" if isinstance(v, float) else str(v)
                       for v in r.values()), flush=True)
    return rows


def main():
    print("topology,n_parties,n_edges,round_s,cloud_wan_MB_per_round,"
          "container_s_per_round,cloud_agg_latency_s,usd_per_round")
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
