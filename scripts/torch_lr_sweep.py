#!/usr/bin/env python3
"""Which depths and local learning rates the port's full-width q/k/v-bias
and MoE families train at on the card, through the main path.

    python3 scripts/torch_lr_sweep.py    # from the repository root, on a card

For each configuration, at full width and bf16, and each depth: the
gradient's largest magnitude and the residual stream's RMS at the seeded
initial model (16 sequences of 64 tokens), then for each lr a
``Platform().train`` run as ``chip_smoke.py`` phase 9 makes it (3 parties,
2 FedAvg rounds, 48 training and 16 eval sequences) and its eval loss
before and after each round.

Why: without qk_norm the reference's initialisation (fan-in taken from the
heads axis) gives q and k entries near 11 and attention scores near 128 in
standard deviation, and every layer adds about 50 to the residual stream.
The gradient then grows with depth, and plain SGD at the main path's lr
blows the residual up: once its squares overflow fp32, the final RMSNorm
returns zeros and the eval loss reads exactly ln(V).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.api import Platform  # noqa: E402
from repro_torch.core.estimator import AggregationEstimator  # noqa: E402
from repro_torch.core.jobspec import FLJobSpec, PartySpec  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

DEPTHS = {"qwen1.5-4b": (2, 3, 4, 8, 20), "qwen2.5-14b": (2, 3),
          "qwen2-moe-a2.7b": (2, 3)}
LRS = (0.05, 0.01, 0.001)


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def at_init(cfg) -> str:
    """Largest |gradient| and the residual stream's RMS at the initial
    model, on 16 random sequences."""
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (16, 64)))
             .cuda() for k in ("tokens", "labels")}
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)[0]
    grads = torch.autograd.grad(loss, leaves)
    g = max(float(x.float().abs().max()) for x in grads)
    del grads, leaves
    with torch.no_grad():
        h = torch.nn.functional.embedding(batch["tokens"], params["embed"])
        pos = torch.arange(64, dtype=torch.int32, device="cuda")
        for i, (pattern, reps) in enumerate(cfg.stages()):
            h, _ = tfm.stage_apply(cfg, pattern, reps, params[f"stage{i}"],
                                   h, positions=pos)
        rms = float(h.float().pow(2).mean().sqrt())
    return f"max |grad| {g:.4g}, residual RMS {rms:.4g}"


def trained(cfg, lr: float) -> str:
    job = FLJobSpec(job_id="sweep", model_arch=cfg.name,
                    model_bytes=M.n_params(cfg) * 2, rounds=2, lr=lr,
                    batch_size=8,
                    parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)})
    res = Platform().train(cfg, job, n_sequences=48, eval_sequences=16,
                           seed=0, estimator=AggregationEstimator(0.01))
    init = M.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v.astype("int64")).cuda()
             for k, v in res.runtime.eval_data.items() if k != "domains"}
    with torch.no_grad():
        loss0 = float(M.loss_fn(cfg, init, batch)[0])
    losses = [loss0] + [r.global_loss for r in res.records]
    return " -> ".join(f"{x:.6f}" for x in losses)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_lr_sweep: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for name, depths in DEPTHS.items():
        for layers in depths:
            cfg = dataclasses.replace(configs.get_config(name),
                                      num_layers=layers)
            print(f"{name}, {layers} layers, ln(V) "
                  f"{np.log(cfg.vocab_size):.6f}: {at_init(cfg)}", flush=True)
            free()
            for lr in LRS:
                print(f"  lr {lr}: eval loss {trained(cfg, lr)}", flush=True)
                free()


if __name__ == "__main__":
    main()
