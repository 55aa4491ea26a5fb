"""Dry run: build every (architecture x input shape) step on "meta"
tensors and run it once, on one card or on the reference's production
layout, and set what it counts beside the analytic roofline.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--single-pod-only]

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each step for a 16 x 16 (or, with ``--multi-pod``, 2 x 16 x 16)
TPU mesh with ``ShapeDtypeStruct`` stand-ins. Here ``launch.steps.build``
gives the step and its arguments on the "meta" device (shapes and dtypes,
no storage), and the step runs once on them: nothing is allocated and no
card is needed, as the reference needs no TPU. Three meshes:

  * ``h100x1`` (the default): the step on one card under
    ``FlopCounterMode``. ``counted_flops`` is its total (matrix products,
    convolutions and attention; elementwise work is not counted), with its
    breakdown by operator; ``memory_analysis`` the meta arguments' bytes
    and the outputs' (``temp_bytes`` is null: meta tensors give no peak);
    ``fits_one_card`` compares the arguments with ``H100.hbm_bytes``. At
    world size 1 no collective exists, and the collective keys are 0.
  * ``16x16`` (256 ranks) and ``2x16x16`` (``--multi-pod``, 512 ranks):
    the step on DTensors placed by ``steps.shardings`` over a layout-only
    process group in this one process (``launch.layout``), each rank's
    block a "meta" tensor. ``collective_bytes_per_device``,
    ``collective_by_kind`` and ``collective_counts`` come from the run's
    ``CollectiveRecord`` under the reference's five kinds and its
    convention: the output bytes of every collective a rank runs in one
    step. Each tensor moves at its own dtype, as on the card, so the one
    byte count is the counterpart of the reference's TPU-adjusted column;
    its CPU-promoted ``collective_bytes_raw_cpu_hlo`` has no counterpart
    and is null. ``counted_flops`` is rank 0's count of its local matrix
    products (the counterpart of ``hlo_flops_per_device``), and
    ``memory_analysis`` its blocks' bytes. ``--profile optimized`` selects
    the reference's optimized rules and model paths.

The roofline terms are ``analytic_roofline(cfg, shape, chips, coll_bytes,
H100)``: one H100's rates, and NVLink's per link for the collective term.
The reference's HLO text parser has no counterpart, since the port never
has HLO: ``collective_bytes`` and ``_shape_bytes`` work on the record and
on a tensor's shape and dtype. The reference's ``--unroll`` has none
either: the port's layers are a Python loop, and every one runs.

``--all`` runs what the reference's driver runs, in this one process (the
reference starts a subprocess each, for its ``XLA_FLAGS``, and so has a
``--timeout``, which the port has no use for): the 10 ``ARCH_IDS`` x 4
``INPUT_SHAPES`` on 16 x 16 and, unless ``--single-pod-only``, on 2 x 16 x
16, and with the baseline profile the one-card rows too (``--mesh`` keeps
one mesh's rows). A combination that fails writes ``ok: false`` and its
error, and the run exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_h100"
MESH = "h100x1"
MESHES = {"h100x1": 1, "16x16": 256, "2x16x16": 512}  # mesh -> ranks
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


def _shape_bytes(shape: Sequence[int], dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (a ``torch.dtype`` or
    its name): the reference's ``_shape_bytes`` of an HLO shape token, at
    the dtype the port moves it in."""
    import torch

    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return math.prod(shape) * dtype.itemsize


def collective_bytes(record):
    """The reference's ``collective_bytes`` on a ``CollectiveRecord``:
    (total, by_kind, counts, total_tpu), the output bytes of every
    collective one rank runs in the step. Each tensor is counted at its
    own dtype, so ``total == total_tpu``."""
    by_kind = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for c in record.items:
        by_kind[c.kind] += c.nbytes
        counts[c.kind] += 1
    total = sum(by_kind.values())
    return total, by_kind, counts, total


def collectives_by_site(record, top: int = 40):
    """The core of ``scripts/torch_analyze_collectives.py`` (the twin of
    the reference's ``scripts/analyze_collectives.py``): the record's
    collectives grouped by (call site, kind, output shape), largest total
    bytes first, at most ``top`` rows of (bytes, kind, shape, cnt, trip,
    site). ``trip`` is the times the site fired (the port's layers are a
    Python loop, not a while body with a trip count), ``cnt`` the
    collectives a firing (1), and a site of the backward is marked
    "(bwd)"."""
    groups: Dict[Tuple, list] = {}
    for c in record.items:
        site = c.site + (" (bwd)" if c.backward else "")
        shape = f"{c.dtype}[{','.join(map(str, c.shape))}]"
        g = groups.setdefault((site, c.kind, shape), [0, 0])
        g[0] += c.nbytes
        g[1] += 1
    rows = [(nb, kind, shape, 1, trip, site)
            for (site, kind, shape), (nb, trip) in groups.items()]
    rows.sort(key=lambda r: (-r[0], r[1], r[2], r[5]))
    return rows[:top]


def mesh_name(multi_pod: bool = False, profile: str = "baseline",
              mesh: Optional[str] = None) -> str:
    """The mesh a run takes: ``mesh`` if given, 2 x 16 x 16 with
    ``multi_pod``, 16 x 16 for the optimized profile (which selects
    sharding rules), else one card."""
    if mesh is None:
        mesh = ("2x16x16" if multi_pod else
                "16x16" if profile != "baseline" else MESH)
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; one of {list(MESHES)}")
    if multi_pod and mesh != "2x16x16":
        raise ValueError(f"--multi-pod is the 2x16x16 mesh, not {mesh}")
    if mesh == MESH and profile != "baseline":
        raise ValueError("the optimized profile selects sharding rules; "
                         "one card has no layout (use a production mesh)")
    return mesh


def run_one(arch: str, shape_name: str, multi_pod: bool = False, *,
            profile: str = "baseline", mesh: Optional[str] = None,
            verbose: bool = True) -> Dict:
    mesh = mesh_name(multi_pod, profile, mesh)
    if mesh != MESH:
        return _run_layout(arch, shape_name, mesh, profile, verbose)
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


def _run_layout(arch: str, shape_name: str, mesh_n: str, profile: str,
                verbose: bool) -> Dict:
    """``run_one`` on a production layout: the step on DTensors over a
    layout-only group of ``MESHES[mesh_n]`` ranks (``launch.layout``)."""
    from repro_torch import configs
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import layout
    from repro_torch.launch.mesh import H100, make_production_mesh
    from repro_torch.launch.roofline import analytic_roofline
    from repro_torch.models import model as M

    configs.load_all()
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    chips = MESHES[mesh_n]
    with layout.layout_group(chips):
        dmesh = make_production_mesh(multi_pod=mesh_n == "2x16x16")
        t0 = time.time()
        fn, dargs = layout.build_on_mesh(cfg, shape, dmesh, profile)
        out, record = layout.run_step(fn, dargs, dmesh, cfg, profile)
        t_count = time.time() - t0
        parts = {name: tree_bytes(layout.local_blocks(a))
                 for name, a in zip(_ARG_NAMES[shape.kind], dargs)}
        out_bytes = tree_bytes(layout.local_blocks(out))
    _, by_kind, counts, coll = collective_bytes(record)
    n_pg, b_pg = record.param_gathers()
    rl = analytic_roofline(cfg, shape, chips, float(coll), H100)
    arg_bytes = sum(parts.values())
    result = {
        "arch": arch,
        "config": cfg.name,
        "shape": shape_name,
        "mesh": mesh_n,
        "chips": chips,
        "kind": shape.kind,
        "ok": True,
        "profile": profile,
        "t_count_s": round(t_count, 1),
        "params": M.n_params(cfg),
        "active_params": M.n_active_params(cfg),
        "flops_global": rl.flops,
        "hbm_bytes_global": rl.hbm_bytes,
        # per device per step, each tensor at its own dtype (the
        # reference's TPU-adjusted column); no CPU-promoted column
        "collective_bytes_per_device": coll,
        "collective_bytes_raw_cpu_hlo": None,
        "collective_by_kind": by_kind,
        "collective_counts": counts,
        "collective_param_gathers": {"count": n_pg, "bytes": b_pg},
        "compute_term_s": rl.compute_s,
        "memory_term_s": rl.memory_s,
        "collective_term_s": rl.collective_s,
        "dominant": rl.dominant,
        "model_flops_global": rl.model_flops,
        "useful_flops_ratio": rl.useful_ratio,
        # rank 0's local matrix products (hlo_flops_per_device's twin)
        "counted_flops": record.flops,
        "counted_over_analytic": (record.flops * chips / rl.flops
                                  if rl.flops else None),
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "output_bytes": out_bytes, "temp_bytes": None,
                            "argument_bytes_by_part": parts},
        "fits_one_card": arg_bytes <= H100.hbm_bytes,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_n} ({profile}) ==")
        print(f"stepped on meta DTensors over {chips} layout-only ranks in "
              f"{t_count:.1f}s")
        print(f"memory per device: arguments {arg_bytes:.3e} B {parts}")
        print(f"counted per device: flops={record.flops:.4e}")
        print(f"analytic: flops={rl.flops:.4e} hbm_bytes={rl.hbm_bytes:.4e}")
        print(f"roofline(s/step): compute={rl.compute_s:.4f} "
              f"memory={rl.memory_s:.4f} collective={rl.collective_s:.4f} "
              f"dominant={rl.dominant}")
        print(f"collectives(per-device B): {coll:.4e} "
              f"{ {k: f'{v:.3e}' for k, v in by_kind.items() if v} } "
              f"counts {counts} parameter gathers {n_pg} ({b_pg:.3e} B)")
        print(f"useful_flops_ratio={rl.useful_ratio:.3f}")
    return result


def _combo_list():
    from repro_torch import configs
    from repro_torch.configs.base import INPUT_SHAPES

    return [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]


def _tasks(multi_pod_also: bool, profile: str, mesh: Optional[str] = None):
    meshes = ["16x16"] + (["2x16x16"] if multi_pod_also else [])
    if profile == "baseline":
        meshes.append(MESH)
    if mesh is not None:
        meshes = [m for m in meshes if m == mesh]
    return [(a, s, m) for a, s in _combo_list() for m in meshes]


def _tag(arch: str, shape: str, mesh: str, profile: str) -> str:
    tag = f"{arch}__{shape}__{mesh}"
    return tag if profile == "baseline" else f"{tag}__{profile}"


def _run_in_process(arch, shape, mesh, profile):
    try:
        return run_one(arch, shape, profile=profile, mesh=mesh,
                       verbose=False)
    except Exception:  # recorded as the reference's driver records it
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "profile": profile, "ok": False,
                "error": traceback.format_exc()[-2000:]}


def driver(only_missing: bool, multi_pod_also: bool = True,
           profile: str = "baseline", mesh: Optional[str] = None):
    """Every combination in this process: 16 x 16 and (with
    ``multi_pod_also``) 2 x 16 x 16 for each (arch, shape), and the
    one-card row under the baseline profile (only ``mesh``'s rows, if
    given). Returns the failed tags."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape, m in _tasks(multi_pod_also, profile, mesh):
        tag = _tag(arch, shape, m, profile)
        out_file = RESULTS / f"{tag}.json"
        if only_missing and out_file.exists():
            if json.loads(out_file.read_text()).get("ok", False):
                continue
        print(f"[driver] {tag} ...", flush=True)
        t0 = time.time()
        out = _run_in_process(arch, shape, m, profile)
        dt = time.time() - t0
        if out.get("ok"):
            print(f"[driver] {tag} ok ({dt:.0f}s)", flush=True)
        else:
            failures.append(tag)
            print(f"[driver] {tag} FAILED ({dt:.0f}s)\n{out['error']}",
                  flush=True)
        out_file.write_text(json.dumps(out, indent=1))
    print(f"[driver] done. {len(failures)} failures: {failures}")
    return failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2 x 16 x 16 mesh (512 ranks)")
    ap.add_argument("--mesh", choices=list(MESHES), default=None,
                    help="h100x1 (default), 16x16 or 2x16x16; with --all, "
                         "that mesh's rows only")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--json", help="write the result JSON to this path")
    args = ap.parse_args(argv)

    if args.all:
        fails = driver(args.only_missing, not args.single_pod_only,
                       args.profile, args.mesh)
        return 1 if fails else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    try:
        mesh = mesh_name(args.multi_pod, args.profile, args.mesh)
    except ValueError as e:
        ap.error(str(e))
    out = run_one(args.arch, args.shape, profile=args.profile, mesh=mesh)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
