"""Quickstart for the `repro_torch.api.Platform` facade — the one surface
over the paper's three execution vehicles:

  1. discrete-event simulation: compare deployment strategies (PolicyConfig)
     on a synthetic 50-party job in milliseconds;
  2. real federated training: 5 parties doing REAL PyTorch local training
     with CUDA-kernel fusion at the aggregator and the JIT timeline priced
     on a virtual clock.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``. Training runs on the card unless
``--device`` names another device; the simulation takes no device.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import Pytree, configs
from repro_torch.api import Platform, TrainingResult, replay_measured
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (AggregationEstimator, JobMetrics, PolicyConfig,
                              STRATEGIES, savings)
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.models import model as M


def simulate() -> Dict[str, JobMetrics]:
    """Vehicle 1: strategy comparison through one Platform per policy."""
    print(f"registered strategies: {', '.join(STRATEGIES)}")
    rng = np.random.default_rng(0)
    # one workload, shared by every strategy (fair comparison)
    job = FLJobSpec(
        job_id="sim", model_arch="effb7", model_bytes=264_000_000,
        rounds=10,
        parties={
            f"p{i}": PartySpec(
                f"p{i}", dataset_size=1000,
                epoch_time_s=float(rng.uniform(200, 900)))
            for i in range(50)
        },
    )
    results = {}
    for strategy in STRATEGIES:
        platform = Platform(t_pair_s=0.079)
        policy = PolicyConfig(strategy=strategy, batch_trigger=10)
        platform.submit(job, policy, seed=0, noise_rel=0.05)
        results[strategy] = platform.run()[job.job_id]
        m = results[strategy]
        print(f"  {strategy:16s} latency={m.mean_latency:7.2f}s "
              f"container_s={m.container_seconds:9.1f}")
    sav = savings(results["eager_serverless"], results["jit"])
    print(f"JIT saves {sav:.1f}% container-seconds vs eager-serverless "
          f"(paper §6.4: 60+%)\n")
    if not sav > 0.0:
        raise AssertionError(f"JIT saved {sav}% against eager-serverless")
    return results


def train(
    cfg: Optional[ModelConfig] = None,
    *,
    rounds: int = 8,
    n_sequences: int = 160,
    device: Union[str, torch.device, None] = None,
    initial_params: Optional[Pytree] = None,
) -> Tuple[TrainingResult, JobMetrics]:
    """Vehicle 3: real PyTorch training + kernel fusion via Platform.train.
    ``cfg`` defaults to the reference's tiny qwen3 (2 layers, d_model 128,
    vocab 256); ``initial_params`` (e.g. the reference's weights through
    ``interop.to_torch``) replaces the seeded initial model. Returns the
    run and always-on's bill on the same measured arrivals."""
    # a tiny dense model (same family as qwen3) so rounds are fast
    cfg = cfg or configs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=128, vocab_size=256
    )
    model_bytes = M.n_params(cfg) * 4

    n_parties = 5
    spec = FLJobSpec(
        job_id="quickstart",
        model_arch=cfg.name,
        model_bytes=model_bytes,
        aggregation_algorithm="fedavg",
        rounds=rounds,
        lr=0.05,
        batch_size=8,
        parties={f"p{i}": PartySpec(f"p{i}") for i in range(n_parties)},
    )

    print(f"model: {cfg.name} ({M.n_params(cfg)/1e6:.1f}M params)")
    result = Platform().train(
        cfg, spec, n_sequences=n_sequences, heterogeneous=True, seed=0,
        verbose=True, device=device, initial_params=initial_params,
    )
    records, metrics = result.records, result.metrics

    first, last = records[0], records[-1]
    print("\n--- summary ---")
    print(f"loss: {first.global_loss:.4f} -> {last.global_loss:.4f}")
    print(f"mean aggregation latency: {metrics.mean_latency:.3f}s")
    print(f"total aggregator container-seconds (JIT): "
          f"{metrics.container_seconds:.2f}")
    # what always-on would have cost: replay the SAME measured arrivals
    # under the eager_ao policy (no retraining)
    ao = replay_measured(
        spec, result.runtime.measured_rounds, "eager_ao",
        cluster_config=result.runtime.cluster_cfg,
        estimator=AggregationEstimator(result.runtime.t_pair0),
    )
    print(f"always-on on the same arrivals: {ao.container_seconds:.2f} "
          f"container-seconds (JIT savings: {savings(ao, metrics):.1f}%; "
          f"NB small rounds are overhead-dominated — paper-scale rounds "
          f"run minutes)")
    if not last.global_loss < first.global_loss:
        raise AssertionError("federated training did not converge")
    return result, ao


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for training (default: the CUDA card)")
    args = ap.parse_args(argv)
    configs.load_all()
    simulate()
    train(device=args.device)


if __name__ == "__main__":
    main()
