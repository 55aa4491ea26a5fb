"""End-to-end example: federated training of the ~100M-parameter
`example-100m` config (12L, d=768, vocab 8k) across 4 parties for a few
hundred local steps total, with JIT-scheduled aggregation.

This is the (b) end-to-end deliverable: real model, real data pipeline,
real optimizer, real fusion kernels, real prediction/scheduling.

  PYTHONPATH=src python -m repro_torch.examples.federated_100m \
      [--rounds N] [--sequences N] [--device cpu]

The port of ``examples/federated_100m.py``; it runs on the card unless
``--device`` names another device. The scheduling timeline is priced by
replaying the measured arrivals through the strategy registry: pass
--policy to cost the same kind of run under eager_ao / eager_serverless /
batched / lazy instead of the default deterministic JIT timeline.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch import Pytree, configs
from repro_torch.api import Platform
from repro_torch.configs.base import ModelConfig
from repro_torch.core import STRATEGIES
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.models import model as M


def run(
    cfg: Optional[ModelConfig] = None,
    *,
    rounds: int = 10,
    n_sequences: int = 192,
    n_parties: int = 4,
    batch_size: int = 8,
    policy: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
    initial_params: Optional[Pytree] = None,
) -> Dict[str, object]:
    """Train ``cfg`` (example-100m by default) with FedProx and print the
    reference's report. Returns the ``TrainingResult`` under "result", the
    final eval loss, the container-seconds, and the mean t_rnd prediction
    error of rounds 2+ (None with one round)."""
    cfg = cfg or configs.get_config("example-100m")
    n_params = M.n_params(cfg)
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, "
          f"{n_parties} parties, {rounds} rounds")
    # steps/round/party = sequences/parties/batch; total local steps:
    steps = rounds * n_sequences // batch_size
    print(f"~{steps} total local train steps")

    spec = FLJobSpec(
        job_id="federated-100m",
        model_arch=cfg.name,
        model_bytes=n_params * 4,
        aggregation_algorithm="fedprox",
        prox_mu=0.001,
        rounds=rounds,
        lr=0.05,
        batch_size=batch_size,
        parties={f"p{i}": PartySpec(f"p{i}") for i in range(n_parties)},
    )
    result = Platform().train(
        cfg, spec, policy=policy, n_sequences=n_sequences,
        heterogeneous=True, eval_sequences=32, seed=0, verbose=True,
        device=device, initial_params=initial_params,
    )
    records = result.records
    print("\nfinal eval loss:", records[-1].global_loss)
    print(f"{result.metrics.strategy} container-seconds: "
          f"{result.metrics.container_seconds:.1f} "
          f"(${result.metrics.cost_usd:.4f})")
    pred_errs = [
        abs(r.t_rnd_pred - max(r.arrivals.values())) / max(r.arrivals.values())
        for r in records[1:]
    ]
    pred_err = sum(pred_errs) / len(pred_errs) if pred_errs else None
    # needs >= 2 rounds (round 1 has no observations yet)
    if pred_err is not None:
        print(f"mean t_rnd prediction error (rounds 2+): "
              f"{100*pred_err:.1f}%")
    return {"result": result, "final_loss": records[-1].global_loss,
            "container_seconds": result.metrics.container_seconds,
            "t_rnd_pred_err": pred_err}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sequences", type=int, default=192)
    ap.add_argument("--parties", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--policy", choices=list(STRATEGIES), default=None,
                    help="deployment strategy to price the run under "
                         "(default: the deterministic JIT timeline)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    configs.load_all()
    run(rounds=args.rounds, n_sequences=args.sequences,
        n_parties=args.parties, batch_size=args.batch_size,
        policy=args.policy, device=args.device)


if __name__ == "__main__":
    main()
