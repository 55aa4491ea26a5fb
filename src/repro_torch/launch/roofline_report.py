"""Aggregates the one-card dry run's JSONs (``results/dryrun_h100/``,
written by ``launch.dryrun``) into the roofline table (markdown) and ranks
the hillclimb candidates.

  PYTHONPATH=src python -m repro_torch.launch.roofline_report [--mesh h100x1]

A copy of the reference's ``launch/roofline_report.py``: ``fmt_row`` gives
the reference's row for the same dict. The terms are one H100's.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_h100"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str = "h100x1", profile: str = "baseline"):
    rows = []
    for f in sorted(RESULTS.glob("*.json")):
        d = json.loads(f.read_text())
        if d.get("mesh") != mesh:
            continue
        if (d.get("profile") or "baseline") != profile:
            continue
        rows.append(d)
    rows.sort(key=lambda d: (d["arch"], SHAPE_ORDER.index(d["shape"])))
    return rows


def fmt_row(d):
    if not d.get("ok"):
        return f"| {d['arch']} | {d['shape']} | FAILED | | | | | | |"
    tot = d["compute_term_s"] + d["memory_term_s"] + d["collective_term_s"]
    frac = max(d["compute_term_s"], d["memory_term_s"],
               d["collective_term_s"]) / tot if tot else 0
    mem = d.get("memory_analysis", {})
    temp = mem.get("temp_bytes")
    args_b = mem.get("argument_bytes")
    return (
        f"| {d['arch']} | {d['shape']} | {d['compute_term_s']:.4f} | "
        f"{d['memory_term_s']:.4f} | {d['collective_term_s']:.4f} | "
        f"**{d['dominant']}** | {d['useful_flops_ratio']:.2f} | "
        f"{(args_b or 0)/1e9:.1f} | {(temp or 0)/1e9:.1f} |"
    )


def fmt_counted(d):
    """The port's addition: FLOPs counted on meta tensors beside the
    analytic count, and the arguments against one card's memory."""
    if not d.get("ok"):
        return f"| {d['arch']} | {d['shape']} | FAILED | | | | |"
    args_b = d["memory_analysis"]["argument_bytes"]
    return (
        f"| {d['arch']} | {d['shape']} | {d['counted_flops']:.4e} | "
        f"{d['flops_global']:.4e} | {d['counted_over_analytic']:.4f} | "
        f"{args_b / 1e9:.3f} | {'yes' if d['fits_one_card'] else 'no'} |"
    )


def efficiency(d):
    """Step-time lower bound = max term; 'roofline fraction' = compute term
    over the max (1.0 = perfectly compute-bound)."""
    mx = max(d["compute_term_s"], d["memory_term_s"], d["collective_term_s"])
    return d["compute_term_s"] / mx if mx else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="h100x1")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.profile)
    print(f"### Roofline table — mesh {args.mesh}, profile {args.profile} "
          f"(seconds per step; H100 terms)\n")
    print("| arch | shape | compute_s | memory_s | collective_s | dominant |"
          " useful_flops | args_GB/dev | temp_GB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        print(fmt_row(d))

    print("\n### FLOPs counted on meta tensors against the analytic count\n")
    print("| arch | shape | counted | analytic | counted/analytic |"
          " args_GB | fits 80 GB |")
    print("|---|---|---|---|---|---|---|")
    for d in rows:
        print(fmt_counted(d))

    ok = [d for d in rows if d.get("ok")]
    print("\n### Hillclimb candidate ranking")
    worst = sorted(ok, key=efficiency)[:5]
    print("\nWorst roofline fraction (compute_term / max_term):")
    for d in worst:
        print(f"  {d['arch']} x {d['shape']}: frac={efficiency(d):.3f} "
              f"dominant={d['dominant']}")
    coll = sorted(ok, key=lambda d: -d["collective_term_s"])[:5]
    print("\nMost collective-bound (absolute seconds):")
    for d in coll:
        print(f"  {d['arch']} x {d['shape']}: "
              f"coll={d['collective_term_s']:.3f}s "
              f"(compute={d['compute_term_s']:.3f}s)")


if __name__ == "__main__":
    main()
