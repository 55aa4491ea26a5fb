"""Aggregation-kernel microbenchmark (``BENCH_kernel.json``): what do the
hand-written CUDA fusion kernels cost, and what does choosing their launch
shape buy?

Two kinds of rows, as in the JAX package's ``benchmarks/kernel_bench.py``:

  model rows     closed-form and fully deterministic, any device: per
                 (kernel, K, N) at the reference's ``MODEL_CASES``, the
                 bytes moved (``kernel_bytes_moved``), the blocks
                 (``grid_steps``), the H100 bandwidth roofline and the
                 modeled time (``modeled_time_s``) at the kernel's default
                 launch shape vs the closed-form ``autotune`` choice.
  measured rows  the card only: per (kernel, K, N), the device time of one
                 launch at three shapes, the default, the closed-form
                 choice and the best of ``autotune.search`` (every legal
                 shape timed with CUDA events through ``autotune._time``:
                 the median of CUDA-graph replays, which leaves out the
                 host's launch cost), beside the launch's bound (its bytes
                 over 3.35 TB/s). The reference times small shapes in
                 interpret mode on the host clock; on the card a small
                 launch times its launch overhead, so each case here moves
                 far more than the 50 MB L2 (N = 2^25, the reference's K
                 and dtypes: fp32 rows, int8 for quant_agg).

  python -m repro_torch.benchmarks.kernel_bench [--check BASELINE]
      [--out OUT] [--emit-cost-table PATH] [--device cpu]

--check holds the run against a baseline written from a run on the card
(``kernel_baseline_h100.json`` beside this file): the deterministic columns
(launch shapes, bytes, blocks, modeled speedup) exactly; each measured
default-vs-tuned and default-vs-best speedup at >= CHECK_SPEEDUP_FRACTION of
the baseline's; and every measured shape's device time within
BOUND_LIMIT x its bound. Host time decides nothing. On the CPU there are no
measured rows, and only the model rows are checked. --emit-cost-table
writes the ``KernelCostTable`` the estimator consumes: measured on the card,
roofline-basis on the CPU.

CSV: see MODEL_HEADER / MEASURED_HEADER.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import get_device
from repro_torch.kernels.autotune import (autotune, best,
                                          build_cost_table, default_of,
                                          grid_steps, kernel_bytes_moved,
                                          modeled_time_s, search)
from repro_torch.kernels.build import default_tile
from repro_torch.launch.roofline import bandwidth_time_s

#: model rows — closed-form, any size is free (the reference's cases)
MODEL_CASES: Tuple[Tuple[str, int, int], ...] = (
    ("fused_agg", 8, 1 << 20),
    ("fused_agg", 32, 1 << 20),
    ("fused_agg", 8, 1 << 22),
    ("quant_agg", 32, 1 << 20),
    ("quant_agg", 64, 1 << 22),
    ("pair_fuse", 2, 1 << 20),
    ("pair_fuse", 2, 1 << 22),
)
#: measured rows — the reference's kernels and K at N = 2^25: each launch
#: moves 0.4-1.2 GB, so it finds its operands cold and its device time
#: follows the bytes, not the launch overhead
MEASURED_CASES: Tuple[Tuple[str, int, int], ...] = (
    ("fused_agg", 8, 1 << 25),
    ("quant_agg", 32, 1 << 25),
    ("pair_fuse", 2, 1 << 25),
)

#: --check: fail if a measured speedup falls below this fraction of the
#: committed baseline's
CHECK_SPEEDUP_FRACTION = 0.7
#: --check: fail if a measured shape's device time exceeds this multiple
#: of its bound
BOUND_LIMIT = 1.25
#: the baseline written from a run on the card
BASELINE = Path(__file__).resolve().parent / "kernel_baseline_h100.json"

MODEL_HEADER = ("kernel,k,n,default_bn,default_kb,tuned_bn,tuned_kb,"
                "bytes_default,bytes_tuned,steps_default,steps_tuned,"
                "h100_roofline_us_default,h100_roofline_us_tuned,"
                "modeled_us_default,modeled_us_tuned,modeled_speedup")
MEASURED_HEADER = ("kernel,k,n,default_bn,default_kb,tuned_bn,tuned_kb,"
                   "best_bn,best_kb,us_default,us_tuned,us_best,us_bound,"
                   "worst_over_bound,measured_speedup,best_speedup")


def model_rows() -> List[Dict]:
    rows = []
    for kernel, k, n in MODEL_CASES:
        dbn, dkb = default_tile(kernel)
        tuned = autotune(kernel, k, n)
        b_def = kernel_bytes_moved(kernel, k, n)
        m_def = modeled_time_s(kernel, k, n, bn=dbn, kb=dkb)
        m_tun = tuned.modeled_s
        rows.append({
            "kernel": kernel, "k": k, "n": n,
            "default_bn": dbn, "default_kb": dkb,
            "tuned_bn": tuned.bn, "tuned_kb": tuned.kb,
            "bytes_default": b_def, "bytes_tuned": tuned.bytes_moved,
            "steps_default": grid_steps(kernel, k, n, bn=dbn, kb=dkb),
            "steps_tuned": grid_steps(kernel, k, n, bn=tuned.bn,
                                      kb=tuned.kb),
            "h100_roofline_us_default": round(
                bandwidth_time_s(b_def) * 1e6, 3),
            "h100_roofline_us_tuned": round(tuned.roofline_s * 1e6, 3),
            "modeled_us_default": round(m_def * 1e6, 3),
            "modeled_us_tuned": round(m_tun * 1e6, 3),
            "modeled_speedup": round(m_def / m_tun, 3),
        })
    return rows


def measured_rows(device=None) -> List[Dict]:
    """The measured rows on ``device`` (the card when None). Raises on any
    device but a CUDA one: the kernels run only on the card."""
    device = get_device(device)
    if device.type != "cuda":
        raise ValueError(f"the measured rows time the CUDA kernels; they "
                         f"need a CUDA device, not {device}")
    rows = []
    for kernel, k, n in MEASURED_CASES:
        timed = search(kernel, n, k, device)
        tuned = autotune(kernel, k, n)
        d, b = default_of(timed), best(timed)
        t = next(r for r in timed if (r.bn, r.kb) == (tuned.bn, tuned.kb))
        bound = b.roofline_s
        rows.append({
            "kernel": kernel, "k": k, "n": n,
            "default_bn": d.bn, "default_kb": d.kb,
            "tuned_bn": t.bn, "tuned_kb": t.kb,
            "best_bn": b.bn, "best_kb": b.kb,
            "us_default": d.graph_s * 1e6, "us_tuned": t.graph_s * 1e6,
            "us_best": b.graph_s * 1e6, "us_bound": bound * 1e6,
            "worst_over_bound": max(d.graph_s, t.graph_s) / bound,
            "measured_speedup": d.graph_s / t.graph_s,
            "best_speedup": d.graph_s / b.graph_s,
        })
    return rows


def speedups(measured: List[Dict]) -> Dict[str, float]:
    out = {}
    for r in measured:
        name = f"{r['kernel']}_k{r['k']}_n{r['n']}"
        out[name] = r["measured_speedup"]
        out[f"{name}_best"] = r["best_speedup"]
    return out


def run(device=None) -> Tuple[List[Dict], List[Dict], Dict[str, float]]:
    """Print and return the model rows, the measured rows and their
    speedups. On the card (``device`` None or CUDA) both kinds; with
    ``device="cpu"`` the model rows only."""
    device = get_device(device)
    print(MODEL_HEADER)
    model = model_rows()
    for r in model:
        print(",".join(str(v) for v in r.values()), flush=True)
    measured: List[Dict] = []
    if device.type == "cuda":
        print(MEASURED_HEADER)
        measured = measured_rows(device)
        for r in measured:
            print(",".join(f"{v:.4f}" if isinstance(v, float) else str(v)
                           for v in r.values()), flush=True)
    else:
        print(f"[no measured rows on {device}: they time the CUDA kernels "
              f"on the card]")
    sp = speedups(measured)
    for name, s in sp.items():
        print(f"[device-time speedup {name}: {s:.4f}x vs the default]")
    return model, measured, sp


#: deterministic model-row columns the baseline locks exactly
DETERMINISTIC_COLS = ("default_bn", "default_kb", "tuned_bn", "tuned_kb",
                      "bytes_default", "bytes_tuned", "steps_default",
                      "steps_tuned", "modeled_speedup")
#: deterministic measured-row columns (the best shape is measured)
DETERMINISTIC_MEASURED_COLS = ("default_bn", "default_kb", "tuned_bn",
                               "tuned_kb")


def check_against(baseline_path: str, model: List[Dict],
                  measured: List[Dict], sp: Dict[str, float]) -> None:
    """Regression guard vs a baseline from the card: launch shapes and
    modeled traffic exact, measured speedups within CHECK_SPEEDUP_FRACTION
    of the baseline's, every measured shape within BOUND_LIMIT x its bound
    in device time. Raises SystemExit(1) on any failure."""
    with open(baseline_path) as f:
        base = json.load(f)
    failures: List[str] = []
    for rows, key, cols in ((model, "model_rows", DETERMINISTIC_COLS),
                            (measured, "measured_rows",
                             DETERMINISTIC_MEASURED_COLS)):
        base_by = {(r["kernel"], r["k"], r["n"]): r for r in base[key]}
        for r in rows:
            b = base_by.get((r["kernel"], r["k"], r["n"]))
            if b is None:
                continue
            for col in cols:
                if r[col] != b[col]:
                    failures.append(
                        f"{r['kernel']}/k{r['k']}/n{r['n']}: {col} {r[col]} "
                        f"!= baseline {b[col]} (tuning/model drift)")
    for name, got in sp.items():
        want = base.get("speedups", {}).get(name)
        if want is None:
            continue
        floor = CHECK_SPEEDUP_FRACTION * want
        if got < floor:
            failures.append(
                f"{name}: measured speedup {got}x < {floor:.2f}x "
                f"(>{100 * (1 - CHECK_SPEEDUP_FRACTION):.0f}% drop vs "
                f"baseline {want}x)")
    for r in measured:
        if r["worst_over_bound"] > BOUND_LIMIT:
            failures.append(
                f"{r['kernel']}/k{r['k']}/n{r['n']}: device time "
                f"{r['worst_over_bound']:.4f} x its bound > {BOUND_LIMIT}")
    if failures:
        print("[kernel regression check FAILED]", file=sys.stderr)
        for msg in failures:
            print("  " + msg, file=sys.stderr)
        raise SystemExit(1)
    print(f"[kernel regression check OK vs {baseline_path}: "
          f"{len(model)} model rows, {len(measured)} measured rows]")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", default="",
                    help="baseline JSON to regression-check against")
    ap.add_argument("--out", default="BENCH_kernel.json",
                    help="write rows as JSON here ('' to skip)")
    ap.add_argument("--emit-cost-table", default="",
                    help="also write a KernelCostTable JSON: measured on "
                         "the card, roofline-basis on the CPU")
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: the model rows only)")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    model, measured, sp = run(device)
    if args.out:
        with open(args.out, "w") as f:
            card = (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else None)
            json.dump({"bench": "kernel", "device": str(device),
                       "card": card, "model_rows": model,
                       "measured_rows": measured, "speedups": sp}, f,
                      indent=1)
        print(f"[wrote {args.out}: {len(model) + len(measured)} rows]")
    if args.emit_cost_table:
        basis = "measured" if device.type == "cuda" else "roofline"
        table = build_cost_table([1 << 20, 4 << 20, 16 << 20, 64 << 20,
                                  256 << 20], basis=basis, device=device)
        table.dump(args.emit_cost_table)
        print(f"[wrote {args.emit_cost_table}: "
              f"{len(table.entries)} {basis} entries]")
    if args.check:
        check_against(args.check, model, measured, sp)
    return model, measured, sp


if __name__ == "__main__":
    main()
