"""Collectives of one architecture's four ``INPUT_SHAPES`` at full size on
the reference's 16 x 16 layout, in both packages: each collective kind's
count and bytes a device, and the all-gathers of parameters.

  PYTHONPATH=src python scripts/torch_collectives_vs_reference.py [--arch qwen3-0.6b]

The reference's side compiles its step (``repro.launch.steps.build``) for a
concrete 16 x 16 ``jax.sharding.Mesh`` of 256 of 512 forced host devices,
one subprocess a shape (``jax.make_mesh`` builds Explicit axes that the
reference's ``constrain`` rejects on JAX 0.9.0, ROADMAP Queue 3), and reads
the partitioned HLO: ``collective_bytes``'s TPU-adjusted bytes, and
``param_gathers``, the all-gathers whose operand is one of the step's model
parameters through ops that only convert, reshape, slice, copy or permute
it. The port's side is ``repro_torch.launch.dryrun.run_one`` on the 16 x 16
layout (meta DTensors over a 256-rank layout-only group). Both run on this
CPU; nothing is timed but the runs.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+) = (.*?) ([a-z][\w\-]*)\(")
_COMP = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(")
_NAME = re.compile(r"%([\w.\-]+)")
_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_PASS = {"convert", "bitcast", "copy", "reshape", "transpose", "slice",
         "copy-start", "copy-done", "bitcast-convert", "dynamic-slice",
         "collective-permute"}


def _operands(line: str, start: int):
    """The %names inside the parenthesised operand list from ``start``."""
    depth, i = 0, start
    while i < len(line):
        if line[i] == "(":
            depth += 1
        elif line[i] == ")":
            depth -= 1
            if depth == 0:
                break
        i += 1
    return _NAME.findall(line[start:i])


def _elements(shape_text: str) -> int:
    m = _SHAPE.search(shape_text)
    if not m or "(" in shape_text.split("[")[0]:
        return 1 << 30  # a tuple
    return int(np.prod([int(d) for d in m.group(2).split(",") if d] or [1]))


def parse(hlo: str):
    """{computation: {name: (opcode, operands, shape text, line)}} and the
    entry computation's name."""
    comps, comp, entry = {}, None, None
    for raw in hlo.splitlines():
        m = _COMP.match(raw) if raw and not raw.startswith(" ") else None
        if m and raw.rstrip().endswith("{"):
            comp = m.group(1)
            comps[comp] = {}
            if raw.startswith("ENTRY"):
                entry = comp
            continue
        m = _INSTR.match(raw)
        if m and comp is not None:
            name, shape, op = m.groups()
            ops = _operands(raw, m.end() - 1)
            comps[comp][name] = (op, ops, shape, raw)
    return comps, entry


def param_gathers(hlo: str, n_params: int, tpu_adjust: bool = True):
    """(count, bytes) of the all-gathers whose operand derives from one of
    the first ``n_params`` entry parameters (the model's), each counted
    at bf16 width where it is f32 (the TPU-adjusted bytes) and times the
    trip count of the while loops around it."""
    from repro.launch.dryrun import _shape_bytes

    comps, entry = parse(hlo)
    derived = {}  # (comp, name) -> bool, or a tuple of bools for tuples
    body_in = {}  # body computation -> flags of its parameter tuple
    trips = {}  # body computation -> (parent computation, trip count)

    def flag(comp, name, seen=()):
        key = (comp, name)
        if key in derived:
            return derived[key]
        if key in seen:
            return False
        op, ops, shape, line = comps[comp][name]
        seen = seen + (key,)
        if op == "parameter":
            idx = int(re.search(r"parameter\((\d+)\)", line).group(1))
            out = (idx < n_params) if comp == entry else \
                body_in.get(comp, ())
        elif op == "tuple":
            out = tuple(_as_bool(flag(comp, o, seen)) for o in ops)
        elif op == "get-tuple-element":
            idx = int(re.search(r"index=(\d+)", line).group(1))
            t = flag(comp, ops[0], seen)
            out = bool(t[idx]) if isinstance(t, tuple) and idx < len(t) \
                else False
        elif op in _PASS and ops:
            out = _as_bool(flag(comp, ops[0], seen))
        elif op == "fusion" and ops:
            parts = [(_as_bool(flag(comp, o, seen)),
                      _elements(comps[comp][o][2])) for o in ops]
            out = any(d for d, _ in parts) and all(
                d or n <= 16 for d, n in parts)
        else:
            out = False
        derived[key] = out
        return out

    # while loops: each body's parameter takes its init tuple's flags
    for comp, instrs in comps.items():
        for name, (op, ops, shape, line) in instrs.items():
            if op != "while":
                continue
            body = re.search(r"body=%([\w.\-]+)", line).group(1)
            trip = re.search(r'"known_trip_count":\{"n":"(\d+)"\}', line)
            trips[body] = (comp, int(trip.group(1)) if trip else 1)
    order = sorted(trips, key=lambda b: _depth(b, trips))
    for body in order:
        parent = trips[body][0]
        for name, (op, ops, shape, line) in comps[parent].items():
            if op == "while" and f"body=%{body}" in line:
                t = flag(parent, ops[0])
                body_in[body] = t if isinstance(t, tuple) else ()

    def mult(c):
        m = 1
        while c in trips:
            c, t = trips[c]
            m *= t
        return m

    count = nbytes = 0
    for comp, instrs in comps.items():
        for name, (op, ops, shape, line) in instrs.items():
            if op not in ("all-gather", "all-gather-start") or not ops:
                continue
            toks = _SHAPE.findall(shape)
            if not all(dt[0] in "bf" for dt, _ in toks):
                continue  # parameters are floating point (a mask is not)
            if not _as_bool(flag(comp, ops[0])):
                continue
            b = sum(_shape_bytes(f"{dt}[{dims}]", tpu_dtype_adjust=tpu_adjust)
                    for dt, dims in toks)
            count += mult(comp)
            nbytes += b * mult(comp)
    return count, nbytes


def _as_bool(x) -> bool:
    return any(x) if isinstance(x, tuple) else bool(x)


def _depth(body, trips) -> int:
    d = 0
    while body in trips:
        body = trips[body][0]
        d += 1
    return d



def reference_one(arch: str, shape: str) -> dict:
    """The reference's step at full size on a concrete 16 x 16 mesh (run
    in a process that forced 512 host devices before importing jax)."""
    import jax
    from jax.sharding import Mesh

    from repro import configs
    from repro.configs.base import INPUT_SHAPES
    from repro.launch import sharding as shd
    from repro.launch import steps
    from repro.launch.dryrun import collective_bytes
    from repro.models import model as M
    from repro.models.sharding_ctx import activation_sharding

    configs.load_all()
    cfg = configs.get_config(arch)
    mesh = Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                ("data", "model"))
    t0 = time.time()
    fn, args, in_sh, donate = steps.build(cfg, INPUT_SHAPES[shape], mesh)
    with activation_sharding(mesh, shd.activation_rules(
            mesh, cfg.sequence_parallel)):
        hlo = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate).lower(
            *args).compile().as_text()
    _, _, counts, total_tpu = collective_bytes(hlo)
    n = len(jax.tree_util.tree_leaves(M.param_specs(cfg)))
    return {"counts": counts, "total": total_tpu,
            "param_gathers": list(param_gathers(hlo, n)),
            "compile_s": round(time.time() - t0, 1)}


def port_one(arch: str, shape: str) -> dict:
    from repro_torch.launch import dryrun

    out = dryrun.run_one(arch, shape, mesh="16x16", verbose=False)
    pg = out["collective_param_gathers"]
    return {"counts": out["collective_counts"],
            "total": out["collective_bytes_per_device"],
            "param_gathers": [pg["count"], pg["bytes"]],
            "step_s": out["t_count_s"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--reference-one", nargs=2, metavar=("ARCH", "SHAPE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference_one:
        print(json.dumps(reference_one(*args.reference_one)))
        return 0

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.pathsep.join([src, os.environ.get(
                   "PYTHONPATH", "")]))
    print(f"{args.arch} on 16 x 16: per device per step; counts AG / AR / RS "
          f"/ A2A / CP; bytes at bf16 width (reference: TPU-adjusted)")
    for shape in args.shapes:
        r = subprocess.run([sys.executable, __file__, "--reference-one",
                            args.arch, shape], capture_output=True,
                           text=True, env=env, timeout=1800)
        if r.returncode:
            raise RuntimeError(r.stderr[-3000:])
        ref = json.loads(r.stdout.strip().splitlines()[-1])
        port = port_one(args.arch, shape)
        for side, d in (("reference", ref), ("port", port)):
            c = " / ".join(str(d["counts"][k]) for k in KINDS)
            print(f"{shape:12s} {side:9s} counts {c:24s} bytes "
                  f"{d['total']:.4e}  parameter gathers "
                  f"{d['param_gathers'][0]} ({d['param_gathers'][1]:.4e} B)"
                  f"  [{d.get('compile_s', d.get('step_s'))} s]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
