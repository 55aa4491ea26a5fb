"""§4.2 claim: "even when training data changes ... linear regression can
be used to predict new epoch times from previous measurements."

A party's local dataset grows g% per round (e.g. data collected during the
day); ground-truth epoch time scales linearly with size (+1% noise). Three
predictors forecast the next round's training time:

  spec-static — the round-0 epoch time from the job spec (no feedback)
  ewma        — periodicity tracker only (lags one round behind drift)
  ours        — periodicity + §4.2 size-aware linear regression
                (UpdatePredictor: regression takes over when the reported
                dataset size changed since the last observation)

CSV: growth_pct,predictor,mean_abs_rel_err_pct,p95_abs_rel_err_pct
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.prediction import PeriodicTracker, UpdatePredictor

ROUNDS = 30
BASE_EPOCH_S = 100.0
BASE_SIZE = 1000


def simulate(growth: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = PartySpec("p0", epoch_time_s=BASE_EPOCH_S, dataset_size=BASE_SIZE)
    job = FLJobSpec(job_id=f"drift-{growth}", model_arch="x",
                    model_bytes=1 << 20, rounds=ROUNDS, parties={"p0": p})
    ours = UpdatePredictor(job)
    ewma = PeriodicTracker()
    comm = ours.t_comm("p0")

    errs = {"spec-static": [], "ewma": [], "ours": []}
    size = float(BASE_SIZE)
    for r in range(ROUNDS):
        # party reports its (grown) dataset size before training this round
        size *= (1.0 + growth)
        p.dataset_size = int(size)
        truth = BASE_EPOCH_S * (size / BASE_SIZE) * float(
            rng.normal(1.0, 0.01))

        preds = {
            "spec-static": BASE_EPOCH_S,
            "ewma": ewma.predict() if ewma.count else BASE_EPOCH_S,
            "ours": ours.t_upd("p0") - comm,
        }
        for k, v in preds.items():
            errs[k].append(abs(v - truth) / truth)

        ours.observe_round("p0", truth)
        ewma.observe(truth)
    return errs


def run(full: bool = False):
    rows = []
    for growth in [0.0, 0.02, 0.05, 0.10]:
        errs = simulate(growth)
        for k, v in errs.items():
            a = 100 * np.asarray(v[3:])  # skip warmup rounds
            rows.append((growth, k, float(a.mean()),
                         float(np.percentile(a, 95))))
            print(f"{growth*100:.0f},{k},{a.mean():.2f},"
                  f"{np.percentile(a, 95):.2f}", flush=True)
    return rows


def main():
    print("growth_pct,predictor,mean_abs_rel_err_pct,p95_abs_rel_err_pct")
    run(full="--full" in sys.argv)


if __name__ == "__main__":
    main()
