#!/usr/bin/env python3
"""How far two runs of ``chip_smoke.py``'s small federated job drift apart,
and, for an MoE config, where their routing first parts.

    python3 scripts/torch_small_agreement.py                # card vs CPU
    python3 scripts/torch_small_agreement.py --devices cpu  # CPU only
    python3 scripts/torch_small_agreement.py --configs qwen2.5-14b \
        --lrs 0.05 --rounds 2

The job is ``chip_smoke.py``'s small card-vs-CPU agreement: the config
reduced to 2 layers, d_model 64, vocab 128, fp32, 3 parties, FedAvg,
``Platform().train`` from the same weights, for each config, each starting
point (``seeded``: the seeded initialisation; ``conditioned``: the same
weights through ``chip_smoke.conditioned``), each lr and each number of
rounds. The runs differ only in what is named:

- one per device in ``--devices``;
- ``cpu+1e-7``: the CPU from the same weights scaled by 1 + ``--perturb``,
  the witness for how far fp32 noise alone carries the job.

Every call of the router is recorded: its input, its top-k experts per
token and the margin between the k-th and the (k+1)-th probability. For
each run against the first, the script prints the eval losses, each fused
leaf's largest difference (absolute and as a share of the leaf's largest
magnitude), whether the leaves pass ``chip_smoke.py``'s tolerance (rtol
1e-4, atol 1e-5), and the first router call whose top-k differs: how many
tokens changed experts there, the margins those tokens had in either run,
and how far the router's inputs had parted by then. A flip at a margin
near fp32 rounding is noise carried through a discrete choice; a flip at
a wide margin means the inputs had already parted for another reason.
It also prints how far the first run moved each leaf from its starting
point: a leaf that moves less than the atol is not tested by the check.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import conditioned  # noqa: E402

from repro_torch import configs, tree_leaves, tree_map  # noqa: E402
from repro_torch.api import Platform  # noqa: E402
from repro_torch.core.jobspec import FLJobSpec, PartySpec  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SEED = 0


def leaf_names(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in
                leaf_names(t, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def run(cfg, init, device: str, lr: float, rounds: int):
    """One run of the small job; returns (eval losses, fused leaves on the
    CPU, router calls as (top-k idx, margin, input) on the CPU)."""
    calls = []
    route = moe._route

    def recording(cfg_, router, x):
        probs, gate, idx = route(cfg_, router, x)
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        k = cfg_.num_experts_per_tok
        calls.append((idx.detach().cpu(),
                      (top[..., k - 1] - top[..., k]).cpu(),
                      x.detach().float().cpu()))
        return probs, gate, idx

    moe._route = recording
    try:
        job = FLJobSpec(
            job_id="small", model_arch=cfg.name,
            model_bytes=M.n_params(cfg) * 4, rounds=rounds, lr=lr,
            batch_size=8,
            parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)})
        res = Platform().train(cfg, job, device=device, initial_params=init,
                               n_sequences=48, eval_sequences=16, seed=SEED)
    finally:
        moe._route = route
    return ([r.global_loss for r in res.records],
            [t.cpu() for t in tree_leaves(res.runtime.global_params)], calls)


def compare(name: str, base, other, names) -> None:
    (la, pa, ca), (lb, pb, cb) = base, other
    print(f"{name}: eval losses {lb} (first run {la}); "
          f"largest loss gap {max(abs(x - y) for x, y in zip(la, lb)):.3e}")
    worst = (0.0, 0.0, "")
    for n, a, b in zip(names, pa, pb, strict=True):
        gap = float((a - b).abs().max())
        rel = gap / max(float(a.abs().max()), 1e-30)
        print(f"  {n:32s} max|diff| {gap:.3e}  share of max|leaf| {rel:.3e}")
        worst = max(worst, (rel, gap, n))
    ok = all(torch.allclose(b, a, rtol=1e-4, atol=1e-5)
             for a, b in zip(pa, pb))
    print(f"  largest share: {worst[0]:.3e} ({worst[2]}, {worst[1]:.3e}); "
          f"{'within' if ok else 'OUTSIDE'} rtol 1e-4, atol 1e-5")
    if not ca:
        return
    if len(ca) != len(cb):
        print(f"  router calls: {len(ca)} vs {len(cb)}")
        return
    drift = [float((xa - xb).abs().max() / xa.abs().max())
             for (_, _, xa), (_, _, xb) in zip(ca, cb)]
    parted = [i for i, ((ia, _, _), (ib, _, _)) in enumerate(zip(ca, cb))
              if not torch.equal(ia, ib)]
    if not parted:
        print(f"  routing: all {len(ca)} router calls chose the same "
              f"experts; router inputs parted by at most {max(drift):.3e} "
              f"of their largest magnitude")
        return
    i = parted[0]
    (ia, ma, _), (ib, mb, _) = ca[i], cb[i]
    moved = (ia != ib).any(-1)
    print(f"  routing: {len(parted)} of {len(ca)} router calls differ; the "
          f"first is call {i}: {int(moved.sum())} of {moved.numel()} tokens "
          f"changed experts, their margins {ma[moved].tolist()} (first run) "
          f"and {mb[moved].tolist()}; the call's smallest margin "
          f"{float(ma.min()):.3e}, median {float(ma.median()):.3e}; router "
          f"inputs parted by {drift[i]:.3e} of their largest magnitude there"
          f" (at most {max(drift[:i] + [0.0]):.3e} before it, "
          f"{max(drift):.3e} over the run)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="qwen2-moe-a2.7b,qwen2.5-14b")
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--lrs", default="0.05,0.002")
    ap.add_argument("--rounds", default="1,2")
    ap.add_argument("--perturb", type=float, default=1e-7)
    args = ap.parse_args()
    if "cuda" in args.devices:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    devices = args.devices.split(",")
    first = devices[0]
    for name in args.configs.split(","):
        cfg = configs.get_config(name).reduced(
            num_layers=2, d_model=64, vocab_size=128, dtype="float32")
        seeded = M.init(cfg, torch.Generator().manual_seed(SEED))
        names = leaf_names(M.param_specs(cfg))
        for start, init in (("seeded", seeded), ("conditioned", conditioned(
                torch, seeded, torch.Generator().manual_seed(SEED)))):
            for lr in map(float, args.lrs.split(",")):
                for rounds in map(int, args.rounds.split(",")):
                    print(f"{cfg.name}, {start} weights: qk_norm="
                          f"{cfg.qk_norm} {cfg.num_experts} experts top-"
                          f"{cfg.num_experts_per_tok}, {rounds} rounds, "
                          f"lr {lr}")
                    runs = {d: run(cfg, init, d, lr, rounds)
                            for d in devices}
                    runs["cpu+1e-7"] = run(
                        cfg, tree_map(lambda t: t * (1 + args.perturb),
                                      init), "cpu", lr, rounds)
                    moved = min(zip((float((a.cpu() - b).abs().max())
                                     for a, b in zip(runs[first][1],
                                                     tree_leaves(init))),
                                    names))
                    print(f"  smallest movement of a leaf in the {first} "
                          f"run: {moved[0]:.3e} ({moved[1]})")
                    for d, r in runs.items():
                        if d != first:
                            compare(f"{d} against {first}", runs[first], r,
                                    names)
                    if first != "cpu" and "cpu" in runs:
                        compare("cpu+1e-7 against cpu", runs["cpu"],
                                runs["cpu+1e-7"], names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
