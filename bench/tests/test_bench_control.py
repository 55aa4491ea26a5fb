"""The control (the reference computed in the precision below the
configuration's, in the program's place) comes out not correct under
each cell's limits, at a size a test run holds. On the card
``bench/control.py`` reads it at the cells' own sizes."""
import pytest
import torch

import control
from fedbench import registry

SEED = 2**31 + 99


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_the_control_fails_a_limit(tiny, cell):
    config, traffic = tiny(cell)
    # the cell's own backlog
    traffic = dict(traffic, updates=registry.traffic(cell)["updates"])
    readings = control.control_readings(cell, SEED, torch.device("cpu"), 2,
                                        config=config, traffic=traffic)
    limits = registry.traffic(cell)["limits"]
    assert any(readings[k] > limit for k, limit in limits.items()), readings


@pytest.mark.card
def test_every_cell_runs_correct_on_the_card(tmp_path):
    """A short run of each cell through ``bench/run.py`` on the card."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in registry.benchmark()["workloads"]:
        proc = subprocess.run(
            [sys.executable, str(registry.BENCH / "run.py"), "--workload",
             cell["name"], "--seed", "2147483901", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True,
            cwd=registry.ROOT, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
