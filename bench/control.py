"""Read the numbers that decide ``correct`` over many seeds in one process,
for the program and for the control, to set the limits from.

    python bench/control.py --workload <cell> --program <seed> ... \
        --control <seed> ... [--rounds N] [--out FILE]

For each ``--program`` seed it sets the cell up as a run does, runs
``--rounds`` rounds as window rounds and prints the readings of the
program against the reference. For each ``--control`` seed it prints the
readings of the control (the reference computed in the precision below
the configuration's) against the reference. One JSON line each, also
appended to ``--out``. The benchmark's runs never run
this. On the card only, like ``run.py``; the tests drive the same
functions on the CPU at small sizes.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def _window(cell_name, seed, device, rounds, config=None, traffic=None):
    """The cell's traffic, set up, after ``rounds`` window rounds."""
    from fedbench import layout, registry

    cell = registry.cell(cell_name)
    config = layout.with_leaves(config or registry.config(cell["config"]))
    traffic = traffic or registry.traffic(cell_name)
    drv = registry.kind(traffic["kind"]).Traffic(cell, config, traffic,
                                                  seed, device)
    drv.setup()
    drv.window = True
    window = [drv.step()["round"] for _ in range(rounds)]
    drv.window = False
    return drv, window


def program_readings(cell_name, seed, device, rounds=3, **files):
    drv, window = _window(cell_name, seed, device, rounds, **files)
    return drv.check(window)


def control_readings(cell_name, seed, device, rounds=3, **files):
    drv, window = _window(cell_name, seed, device, rounds, **files)
    return drv.control(window)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    jobs = [("program", s, program_readings) for s in args.program] + \
           [("control", s, control_readings) for s in args.control]
    for side, seed, fn in jobs:
        t0 = time.perf_counter()
        readings = fn(args.workload, seed, device, args.rounds)
        line = json.dumps({"cell": args.workload, "side": side, "seed": seed,
                           "readings": readings,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
