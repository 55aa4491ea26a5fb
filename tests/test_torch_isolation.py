"""The port stands alone: no module of ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX, the JAX package or its benchmarks
(``benchmarks/``), importing every port module loads none of them, and the
entry points run on the card unless the caller names another device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."  # relative imports stay inside the package
            else:
                yield node.module


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_the_file_list_walks_every_subpackage():
    packages = {p.parent for p in PORT.rglob("__init__.py")}
    assert PORT / "benchmarks" in packages
    assert packages == {p.parent for p in FILES if p.parent != ROOT}
    assert PORT / "benchmarks" / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    bad = [m for m in _modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = list(_port_modules())
    assert len(mods) > 30
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(len(bad), bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_entry_points_need_the_card_unless_told_otherwise(monkeypatch):
    import torch

    from repro_torch import configs, get_device, interop
    from repro_torch.api import Platform
    from repro_torch.core.jobspec import FLJobSpec, PartySpec
    from repro_torch.fl.job import FLJobRuntime
    from repro_torch.fl.party import Party

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    configs.load_all()
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=1, d_model=32, vocab_size=64, d_ff=64)
    spec = FLJobSpec(job_id="j", model_arch=cfg.name, model_bytes=1024,
                     rounds=1, parties={"p0": PartySpec("p0")})
    data = {"tokens": np.zeros((2, 4), np.int32),
            "labels": np.zeros((2, 4), np.int32)}
    for call in (lambda: get_device(),
                 lambda: Party("p0", cfg, data),
                 lambda: FLJobRuntime(cfg, spec),
                 lambda: Platform().train(cfg, spec),
                 lambda: interop.to_torch({"w": np.zeros(3, np.float32)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert get_device("cpu") == torch.device("cpu")
