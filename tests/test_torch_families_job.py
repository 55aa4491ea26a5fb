"""``FLJobRuntime`` of the port against the JAX package's for a q/k/v-bias
config, qwen2.5-14b (the MoE config, qwen2-moe-a2.7b, is held the same way
in ``test_torch_moe_job.py``), reduced as in ``test_torch_families.py``
with the biases redrawn at random: 3 parties, 2 FedAvg rounds at lr 0.05,
fp32, both started from the same weights and fed the same numpy-seeded
data, compared round by round. The other configs train one party's local
round against the reference's ``Party``.

Tolerances, as ``test_torch_job.py``: eval losses and fused parameters
within rtol 1e-4 / atol 1e-5. The weights are the reference's init with
the attention projections rescaled to a fan-in over their input axes
(``_torch_families._params(condition=True)``). From the init alone these
configs, which have no qk_norm, get sharply peaked attention and training
is chaotic: scaling the initial weights by 1 + 1e-7 moves a 2-round run's
parameters by up to 7.9e-3 (``scripts/torch_small_agreement.py``), so no
implementation could be held to these tolerances there. From the
conditioned weights the same change moves them by under 4e-7.
"""
import pytest
import torch

from _torch_families import (check_party_round_matches_reference,
                             check_runtime_matches_reference)

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def test_runtime_matches_reference_round_by_round():
    check_runtime_matches_reference("qwen2.5-14b")


@pytest.mark.parametrize("name", ["qwen1.5-4b", "minitron-8b"])
def test_party_round_matches_reference(name):
    """The dense configs the runtime test above does not train (llama4 is
    held so in ``test_torch_moe_job.py``): one party's local round (2 SGD
    steps at lr 0.05 on 16 numpy-seeded sequences) from the same
    conditioned weights, against the reference's Party; the trained
    parameters within rtol 1e-4 / atol 1e-5, the last loss within rtol
    1e-5."""
    check_party_round_matches_reference(name)
