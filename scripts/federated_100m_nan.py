#!/usr/bin/env python3
"""Where the federated_100m example's training first turns NaN, in the JAX
package and in the port, on the CPU.

    PYTHONPATH=src python scripts/federated_100m_nan.py [--rounds 1]

Both packages build the example's job at its defaults (example-100m at full
width and depth, 4 parties, 192 sequences split unevenly, batches of 8,
FedProx with mu 0.001, lr 0.05, seed 0) and run ``--rounds`` rounds; each
party's every local step records its loss. Three runs:

- ``reference``: the JAX package's ``FLJobRuntime`` from its own seeded
  weights;
- ``port, reference weights``: the port's from the same weights, carried
  over by ``interop.to_torch``;
- ``port, own weights``: the port's from its own seeded weights (those
  ``chip_smoke.py`` phase 10 starts from on the card are drawn by the
  card's generator, and differ again).

For each run it prints every step's loss, the first step whose loss is not
finite as (round, party, step within the party's round), and the eval
loss after each round. ``chip_smoke.py`` phase 10 holds the port's run on
the card to the point printed here. This script needs the JAX package, so
it does not run on a machine without JAX.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def job(jobspec, n_parties: int = 4):
    return jobspec.FLJobSpec(
        job_id="federated-100m", model_arch="example-100m",
        model_bytes=0, aggregation_algorithm="fedprox", prox_mu=0.001,
        rounds=10, lr=0.05, batch_size=8,
        parties={f"p{i}": jobspec.PartySpec(f"p{i}")
                 for i in range(n_parties)})


def record_steps(runtime, steps: list) -> None:
    """Wrap each party's local step so that it appends (round, party, step,
    loss); calibration ran in the constructor and is not recorded."""
    for pid, party in runtime.parties.items():
        def rec(params, opt_state, batch, gp, _pid=pid, _step=party._step):
            out = _step(params, opt_state, batch, gp)
            rnd = len(runtime.records)
            k = sum(1 for r, p, _, _ in steps if r == rnd and p == _pid)
            steps.append((rnd, _pid, k, float(out[2])))
            return out
        party._step = rec


def report(name: str, runtime, steps: list) -> None:
    print(f"{name}:")
    for rnd, pid, k, loss in steps:
        print(f"  round {rnd} {pid} step {k}: loss {loss}")
    bad = next(((r, p, k) for r, p, k, x in steps if not math.isfinite(x)),
               None)
    print(f"  first non-finite step (round, party, step): {bad}")
    print(f"  eval loss by round: {[r.global_loss for r in runtime.records]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()

    import jax
    import numpy as np
    from repro import configs as jconfigs
    from repro.core import jobspec as jjobspec
    from repro.fl.job import FLJobRuntime as JRuntime
    from repro.models import model as JM
    from repro_torch import configs, interop
    from repro_torch.core import jobspec
    from repro_torch.fl.job import FLJobRuntime
    from repro_torch.models import model as M

    jconfigs.load_all()
    jcfg = jconfigs.get_config("example-100m")
    spec = job(jjobspec)
    spec.model_bytes = JM.n_params(jcfg) * 4
    kw = dict(n_sequences=192, heterogeneous=True, eval_sequences=32, seed=0)
    ref = JRuntime(jcfg, spec, **kw)
    init = interop.to_torch(jax.tree.map(np.asarray, ref.global_params),
                            device="cpu")
    steps: list = []
    record_steps(ref, steps)
    ref.run(rounds=args.rounds, verbose=False)
    report("reference", ref, steps)
    del ref

    configs.load_all()
    cfg = configs.get_config("example-100m")
    for name, weights in (("port, reference weights", init),
                          ("port, own weights", None)):
        spec = job(jobspec)
        spec.model_bytes = M.n_params(cfg) * 4
        rt = FLJobRuntime(cfg, spec, device="cpu", initial_params=weights,
                          **kw)
        steps = []
        record_steps(rt, steps)
        rt.run(rounds=args.rounds, verbose=False)
        report(name, rt, steps)
        del rt
    return 0


if __name__ == "__main__":
    sys.exit(main())
