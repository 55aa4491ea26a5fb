#!/usr/bin/env python3
"""Where full-width mamba2-130m's federated training turns NaN, and why.

    PYTHONPATH=src python scripts/ssd_overflow.py --device cpu
    PYTHONPATH=src python scripts/ssd_overflow.py --device cpu --lr 0.01 \
        --conditioned

For each local lr: ``Platform().train`` of mamba2-130m at full width and
depth (bf16) as ``chip_smoke.py`` phase 12 runs it (3 parties, 2 FedAvg
rounds, 48 training and 16 eval sequences of 64 tokens, seed 0), from the
seeded weights or, with ``--conditioned``, from ``chip_smoke.conditioned``
ones (dt_bias drawn as Mamba-2 initialises it). Printed per round: the
largest exponent the SSD pass takes in a chunk's masked triangle (its
``exp`` overflows fp32 past 88.72) and the eval loss. At the first local
step whose gradient is not finite, the same weights and batch go through
the JAX package's loss gradient on the CPU (``--reference``), which shows
the fault is the reference's: ``_ssd_chunked`` masks ``exp(ldec)`` after
taking it, and the gradient through the mask is 0 * inf.

On the CPU one lr takes about a minute and 3 GB. The results move with
the thread count (sums in other orders): it is fixed at 8.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import configs, get_device, interop, tree_leaves  # noqa: E402
from repro_torch.api import Platform  # noqa: E402
from repro_torch.core.estimator import AggregationEstimator  # noqa: E402
from repro_torch.core.jobspec import FLJobSpec, PartySpec  # noqa: E402
from repro_torch.fl import job as job_mod  # noqa: E402
from repro_torch.fl import party as party_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

OVERFLOW = float(np.log(np.finfo(np.float32).max))  # 88.72


class Watch:
    """Patches the SSD pass to record its largest masked exponent, and the
    parties' gradient to stop at the first non-finite one."""

    def __init__(self):
        self.largest = 0.0
        self.bad = None  # (party, weights, batch) of the first NaN step
        chunked, grads, step = (ssm._ssd_chunked, party_mod.Party._grads,
                                party_mod.Party._step)
        watch = self

        def recorded(x, a, bm, cm, chunk, init_state):
            with torch.no_grad():
                b, s, h = a.shape
                q = min(chunk, s)
                cum = torch.cumsum(a.reshape(b, s // q, q, h), dim=2)
                ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
                watch.largest = max(watch.largest, float(ldec.max()))
            return chunked(x, a, bm, cm, chunk, init_state)

        def checked(party, params, loss_of):
            g, loss = grads(party, params, loss_of)
            if watch.bad is None and not all(
                    bool(torch.isfinite(x).all()) for x in tree_leaves(g)):
                watch.bad = (party.party_id, interop.to_numpy(params),
                             {k: v.cpu().numpy()
                              for k, v in party._batch.items()})
            return g, loss

        def stepped(party, params, opt_state, batch, global_params):
            party._batch = batch
            return step(party, params, opt_state, batch, global_params)

        ssm._ssd_chunked = recorded
        party_mod.Party._grads = checked
        party_mod.Party._step = stepped


def reference_gradient(cfg_name: str, weights, batch) -> str:
    """The JAX package's loss gradient on the same weights and batch: the
    names of its non-finite leaves."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import model as JM

    jconfigs.load_all()
    jcfg = jconfigs.get_config(cfg_name)
    params = jax.tree.map(
        lambda a: jnp.asarray(a.view(jnp.bfloat16)) if a.dtype == np.uint16
        else jnp.asarray(a), weights)
    jb = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)[0]))(params)
    bad = [jax.tree_util.keystr(p) for p, x in
           jax.tree_util.tree_flatten_with_path(grads)[0]
           if not bool(jnp.isfinite(x.astype(jnp.float32)).all())]
    return f"reference loss {float(loss):.6f}, non-finite gradient leaves {bad}"


def run(lr: float, conditioned: bool, device, reference: bool) -> None:
    cfg = configs.get_config("mamba2-130m")
    watch = Watch()
    init = M.init(cfg, torch.Generator(device=device).manual_seed(0))
    if conditioned:
        init = chip_smoke.conditioned(torch, init,
                                      torch.Generator().manual_seed(0))
    job = FLJobSpec(job_id="ssd", model_arch=cfg.name,
                    model_bytes=M.n_params(cfg) * 2, rounds=2, lr=lr,
                    batch_size=8,
                    parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)})
    run_round = job_mod.FLJobRuntime.run_round

    def traced(rt, i):
        watch.largest = 0.0
        rec = run_round(rt, i)
        print(f"  round {i}: largest masked exponent {watch.largest:.4f} "
              f"(overflow past {OVERFLOW:.4f}); eval loss "
              f"{rec.global_loss:.6f}", flush=True)
        return rec

    job_mod.FLJobRuntime.run_round = traced
    try:
        res = Platform().train(cfg, job, device=device, n_sequences=48,
                               eval_sequences=16, seed=0, initial_params=init,
                               estimator=AggregationEstimator(0.01))
    finally:
        job_mod.FLJobRuntime.run_round = run_round
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(device)
             for k, v in res.runtime.eval_data.items() if k != "domains"}
    with torch.no_grad():
        loss0 = float(M.loss_fn(cfg, init, batch)[0])
    print(f"  eval loss before {loss0:.6f}", flush=True)
    if watch.bad is not None:
        pid, weights, nan_batch = watch.bad
        print(f"  first non-finite gradient: party {pid}", flush=True)
        if reference:
            print("  " + reference_gradient(cfg.name, weights, nan_batch),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, action="append",
                    help="local learning rates (default: 0.05)")
    ap.add_argument("--conditioned", action="store_true")
    ap.add_argument("--reference", action="store_true",
                    help="at the first NaN step, the JAX package's gradient")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    torch.set_num_threads(8)
    configs.load_all()
    for lr in args.lr or [0.05]:
        print(f"mamba2-130m, lr {lr}, "
              f"{'conditioned' if args.conditioned else 'seeded'} weights, "
              f"{device}", flush=True)
        run(lr, args.conditioned, device, args.reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
