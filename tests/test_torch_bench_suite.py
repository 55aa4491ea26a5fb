"""The benchmark harness's own CPU tests (``bench/tests``), run in a fresh
process: ``bench/fedbench/runner.py`` refuses a process that has loaded
the JAX package, as any process that has run this directory's tests
has."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_bench_suite_passes():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "bench/tests"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert " passed" in proc.stdout.splitlines()[-1]
