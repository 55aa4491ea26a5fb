"""``FLJobRuntime`` of the port against the JAX package's for the MoE config
qwen2-moe-a2.7b (60 routed experts top-4, 4 shared, q/k/v bias), reduced
as in ``test_torch_families.py``: 3 parties, 2 FedAvg rounds, fp32, from
the conditioned weights and at the tolerances of
``test_torch_families_job.py`` (whose docstring says why); and one party's
local round of llama4-scout-17b-a16e.
"""
import torch

from _torch_families import (check_party_round_matches_reference,
                             check_runtime_matches_reference)

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def test_runtime_matches_reference_round_by_round():
    check_runtime_matches_reference("qwen2-moe-a2.7b")


def test_party_round_matches_reference():
    """llama4-scout-17b-a16e (16 experts top-1, 1 shared), which no runtime
    test trains: one party's local round against the reference's Party,
    held as ``test_torch_families_job.py`` holds the dense configs."""
    check_party_round_matches_reference("llama4-scout-17b-a16e")
