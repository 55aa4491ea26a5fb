"""One run of one cell: load, warm up, measure for the window, read the
metrics, check what the timed path produced, and build the result line.

The window runs whole steps of the cell's traffic (rounds) back to back
and closes at the end of the first step that ends ``seconds`` or more
after it opened; the traffic's ``window`` is true meanwhile. With
``trace`` the window runs with the per-layer spans on, and one more step
runs under the device trace after it."""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, Optional

import torch

from fedbench import devtrace, layout, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        config: Optional[Dict] = None, traffic: Optional[Dict] = None
        ) -> Dict:
    """The result line's object. ``config`` / ``traffic`` replace the
    cell's files (small sizes on the CPU in the tests)."""
    cell = registry.cell(cell_name)
    config = layout.with_leaves(config or registry.config(cell["config"]))
    traffic = traffic or registry.traffic(cell_name)
    drv = registry.kind(traffic["kind"]).Traffic(cell, config, traffic,
                                                  seed, device)
    drv.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"{cell_name} seed {seed}: set up in {setup_s:.3f} s "
        f"{getattr(drv, 'setup_parts', '')}")

    if trace and hasattr(drv, "trace_spans"):
        drv.trace_spans = True
    steps = []
    drv.window = True
    t0 = time.perf_counter()
    while True:
        s = drv.step()
        s["t_end"] = time.perf_counter() - t0
        steps.append(s)
        if s["t_end"] >= seconds:
            break
    window_s = time.perf_counter() - t0
    drv.window = False
    log(f"window: {len(steps)} steps, {sum(s['units'] for s in steps)} "
        f"{drv.unit} in {window_s:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"loaded in the run: {', '.join(bad)}")

    summary, traced = None, None
    if trace:
        with devtrace.DeviceTrace(device) as tr:
            traced = drv.step()
        summary = tr.summary
        log(f"traced step: busy {summary['busy_s']:.4f} s of "
            f"{summary['window_s']:.4f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    rec = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "trace": summary, "traced_step": traced, "seed": seed,
           "cell": cell_name, "traffic": traffic, **drv.record()}
    metrics = {}
    for m in registry.metrics_of(cell_name, trace):
        value = registry.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    readings = drv.check([s["round"] for s in steps])
    log(f"checked against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")
    limits = traffic["limits"]  # the numbers the cell compares
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    attempted = sum(s.get("attempted", s["units"]) for s in steps)
    failed = attempted - sum(s["units"] for s in steps)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if summary is not None:
        out["breakdown"] = devtrace.breakdown(summary)
    out["checks"] = checks
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
