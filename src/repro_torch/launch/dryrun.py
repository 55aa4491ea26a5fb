"""One-card dry run: build every (architecture x input shape) step on
"meta" tensors, run it once under ``torch.utils.flop_counter``, and set the
FLOPs it counts beside the analytic roofline of one H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each step for a 16 x 16 TPU mesh with ``ShapeDtypeStruct``
stand-ins. Here ``launch.steps.build`` gives the step and its arguments on
the "meta" device (shapes and dtypes, no storage), and the step runs once
on them: nothing is allocated and no card is needed, as the reference needs
no TPU. What each number becomes:

  * ``counted_flops``: the total of ``FlopCounterMode`` (matrix products,
    convolutions and attention; elementwise work is not counted), with its
    breakdown by operator (the port's models are functions, not
    ``nn.Module``s, so there is no breakdown by module). The reference's
    ``hlo_flops_per_device`` has no counterpart.
  * ``memory_analysis``: the meta arguments' bytes (params, optimizer state,
    batch, cache) and the step's outputs' bytes; ``temp_bytes`` is null,
    since meta tensors give no peak. ``fits_one_card`` compares the argument
    bytes with ``H100.hbm_bytes``.
  * the collective keys are 0: at world size 1 no collective exists. The
    reference's HLO parser (``_shape_bytes``, ``collective_bytes``) is not
    ported: the port never has XLA HLO.
  * the roofline terms: ``analytic_roofline(cfg, shape, 1, 0.0, H100)``.

``--all`` runs the 10 ``ARCH_IDS`` x 4 ``INPUT_SHAPES`` in one process (the
reference starts a subprocess each, for its ``XLA_FLAGS``); a combination
that fails writes ``ok: false`` and its error, and the run exits non-zero.
``--profile optimized`` and ``--multi-pod``
select the reference's mesh layouts, which the port does not have yet, and
raise. The reference's ``--unroll`` has no counterpart: the port's layers
are a Python loop, and every one is counted.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_h100"
MESH = "h100x1"
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# names of the step's arguments, by kind (launch.steps.build)
_ARG_NAMES = {
    "train": ("params", "opt_state", "batch"),
    "prefill": ("params", "tokens", "image_embeds"),
    "decode": ("params", "cache", "tokens"),
}


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (meta tensors included)."""
    import torch

    from repro_torch import tree_leaves

    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)))


def counted_flops(fn, *args) -> Tuple[object, int, Dict[str, int]]:
    """Run ``fn(*args)`` under ``FlopCounterMode``: (its output, the total
    FLOPs counted, the FLOPs by operator)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    by_op = counter.get_flop_counts().get("Global", {})
    return (out, int(counter.get_total_flops()),
            {str(k): int(v) for k, v in sorted(by_op.items(), key=str)})


def run_one(arch: str, shape_name: str, *, verbose: bool = True) -> Dict:
    from repro_torch import configs
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import analytic_roofline
    from repro_torch.models import model as M

    configs.load_all()
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    chips = 1

    t0 = time.time()
    fn, args, _ = steps_mod.build(cfg, shape)
    out, flops, by_op = counted_flops(fn, *args)
    t_count = time.time() - t0

    parts = {name: tree_bytes(a)
             for name, a in zip(_ARG_NAMES[shape.kind], args)}
    arg_bytes = sum(parts.values())
    mem_d = {"argument_bytes": arg_bytes, "output_bytes": tree_bytes(out),
             "temp_bytes": None, "argument_bytes_by_part": parts}
    rl = analytic_roofline(cfg, shape, chips, 0.0, H100)

    result = {
        "arch": arch,
        "config": cfg.name,
        "shape": shape_name,
        "mesh": MESH,
        "chips": chips,
        "kind": shape.kind,
        "ok": True,
        "profile": "baseline",
        "t_count_s": round(t_count, 1),
        "params": M.n_params(cfg),
        "active_params": M.n_active_params(cfg),
        # roofline terms (analytic FLOPs and bytes; no collective at 1 card)
        "flops_global": rl.flops,
        "hbm_bytes_global": rl.hbm_bytes,
        "collective_bytes_per_device": 0,
        "collective_bytes_raw_cpu_hlo": 0,
        "collective_by_kind": {k: 0 for k in _COLLECTIVES},
        "collective_counts": {k: 0 for k in _COLLECTIVES},
        "collective_note": "world size 1: no collective exists",
        "compute_term_s": rl.compute_s,
        "memory_term_s": rl.memory_s,
        "collective_term_s": rl.collective_s,
        "dominant": rl.dominant,
        "model_flops_global": rl.model_flops,
        "useful_flops_ratio": rl.useful_ratio,
        # what FlopCounterMode counts when the step runs on meta tensors
        "counted_flops": flops,
        "counted_flops_by_op": by_op,
        "counted_over_analytic": flops / rl.flops if rl.flops else None,
        "memory_analysis": mem_d,
        "fits_one_card": arg_bytes <= H100.hbm_bytes,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {MESH} ==")
        print(f"built and counted on meta tensors in {t_count:.1f}s")
        print(f"memory: arguments {arg_bytes:.3e} B {parts}, outputs "
              f"{mem_d['output_bytes']:.3e} B, fits one card: "
              f"{result['fits_one_card']}")
        print(f"counted: flops={flops:.4e} {by_op}")
        print(f"analytic: flops={rl.flops:.4e} hbm_bytes={rl.hbm_bytes:.4e}"
              f" counted/analytic={result['counted_over_analytic']:.4f}")
        print(f"roofline(s/step): compute={rl.compute_s:.4f} "
              f"memory={rl.memory_s:.4f} collective={rl.collective_s:.4f} "
              f"dominant={rl.dominant}")
        print(f"useful_flops_ratio={rl.useful_ratio:.3f}")
    return result


def _combo_list():
    from repro_torch import configs
    from repro_torch.configs.base import INPUT_SHAPES

    return [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]


def driver(only_missing: bool):
    """Every combination in this process; returns the failed tags."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape in _combo_list():
        tag = f"{arch}__{shape}__{MESH}"
        out_file = RESULTS / f"{tag}.json"
        if only_missing and out_file.exists():
            if json.loads(out_file.read_text()).get("ok", False):
                continue
        print(f"[driver] {tag} ...", flush=True)
        t0 = time.time()
        try:
            out = run_one(arch, shape, verbose=False)
        except Exception:  # recorded as the reference's driver records it
            failures.append(tag)
            err = traceback.format_exc()[-2000:]
            out = {"arch": arch, "shape": shape, "mesh": MESH, "ok": False,
                   "error": err}
            print(f"[driver] {tag} FAILED ({time.time() - t0:.0f}s)\n{err}",
                  flush=True)
        else:
            print(f"[driver] {tag} ok ({time.time() - t0:.0f}s)", flush=True)
        out_file.write_text(json.dumps(out, indent=1))
    print(f"[driver] done. {len(failures)} failures: {failures}")
    return failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2 x 16 x 16 mesh (not ported)")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--json", help="write the result JSON to this path")
    args = ap.parse_args(argv)
    if args.multi_pod or args.profile != "baseline":
        raise NotImplementedError(
            "--multi-pod and --profile optimized select the reference's "
            "production mesh and its shardings, which the port does not "
            "have yet; the dry run covers one card")

    if args.all:
        fails = driver(args.only_missing)
        return 1 if fails else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    out = run_one(args.arch, args.shape)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
