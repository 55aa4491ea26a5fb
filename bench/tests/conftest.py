"""Tests of the benchmark harness. They run on the CPU at small sizes;
a test that needs the card carries the ``card`` marker and skips itself
when there is none.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips itself without one")


#: small same-family configurations for CPU runs of the harness
TINY = {
    "qwen3-0.6b": {"name": "tiny-qwen3", "run": {
        "arch": "qwen3-0.6b", "dtype": "bfloat16", "num_layers": 2,
        "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 128, "block_pattern": ["attn"]}},
    "mamba2-130m": {"name": "tiny-mamba2", "run": {
        "arch": "mamba2-130m", "dtype": "bfloat16", "num_layers": 2,
        "d_model": 64, "vocab_size": 128, "ssm_state": 16, "ssm_heads": 4,
        "ssm_head_dim": 32, "ssm_expand": 2, "conv_kernel": 4,
        "block_pattern": ["ssm"]}},
}


def tiny_files(cell_name):
    """(config, traffic) of ``cell_name`` at a size the CPU runs in
    seconds: the tiny configuration, fewer updates and a smaller pool."""
    from fedbench import registry

    cell = registry.cell(cell_name)
    traffic = dict(registry.traffic(cell_name), updates=60, pool=4)
    return TINY[cell["config"]], traffic


@pytest.fixture
def tiny():
    return tiny_files
