"""The train steps of ``test_torch_layout.py``'s comparison: each reduced
``ARCH_IDS`` x train at B 8 x 64 on a 2 x 2 layout, the port's
``CollectiveRecord`` and the reference's partitioned HLO computed here,
against ``STEPS`` (``tests/_torch_layout.py``). In its own file for the
time its ten compiles take.

Tolerance: none; counts and bytes are integers and agree exactly.
"""
import pytest

from _torch_layout import check_step
from repro_torch import configs

configs.load_all()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_train_step_collectives_against_the_reference(arch):
    check_step(arch, "train")

