"""Finds the benchmark's parts by name: the cells and metrics of
``BENCHMARK.json``, a configuration's file, a cell's traffic file
(``workloads/<cell>.json``), the code of a traffic kind
(``fedbench/kinds/<kind>.py``) and a metric's reader
(``metrics/<metric>.py``). Adding a cell, configuration or metric adds
files; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def _load_json(path: Path, what: str) -> Dict:
    if not path.is_file():
        raise KeyError(f"no {what} file {path}")
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return _load_json(ROOT / "BENCHMARK.json", "benchmark")


def cell(name: str) -> Dict:
    """The cell's entry of ``BENCHMARK.json``; raises for an unknown one."""
    for w in benchmark()["workloads"]:
        if w["name"] == _checked(name, "cell"):
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    for c in benchmark()["configs"]:
        if c["name"] == _checked(name, "configuration"):
            return _load_json(ROOT / c["file"], "configuration")
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(cell_name: str) -> Dict:
    return _load_json(BENCH / "workloads" / f"{_checked(cell_name, 'cell')}.json",
                      "traffic")


def kind(name: str):
    """The module that runs traffic of kind ``name``."""
    _checked(name, "traffic kind")
    if not (BENCH / "fedbench" / "kinds" / f"{name}.py").is_file():
        raise KeyError(f"no code for traffic kind {name!r}")
    return importlib.import_module(f"fedbench.kinds.{name}")


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{_checked(metric, 'metric')}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        "fedbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a ``workloads`` key limits one)."""
    b = benchmark()
    out = []
    for m in b["per_layer" if trace else "end_to_end"]:
        cells: Optional[List[str]] = m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out
