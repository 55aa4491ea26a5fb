"""Two FedAvg rounds of the SSM, hybrid RG-LRU and audio families through
the port's ``Platform.train`` against the JAX package's ``FLJobRuntime``,
on the CPU, from the same weights; and the VLM's refusal in both packages.

Configs reduced as in ``_torch_families.py`` (d_model 64, vocab 128, fp32;
recurrentgemma-9b at 5 layers, its remainder stage included), 3 parties,
48 sequences, lr 0.05. Eval losses and the fused parameters of each round
within rtol 1e-4 / atol 1e-5 (fp32 products summed in other orders over
local SGD), from ``_params(condition=True)`` weights: recurrentgemma-9b's
and musicgen-large's attention has no qk_norm, and from the init alone
such a job is chaotic (``test_torch_families_job.py``).
"""
import pytest
import torch

from repro import configs as jconfigs
from repro.api import Platform as JPlatform
from repro.core.jobspec import FLJobSpec as JFLJobSpec
from repro.core.jobspec import PartySpec as JPartySpec
from repro_torch.api import Platform
from repro_torch.core.jobspec import FLJobSpec, PartySpec

from _torch_families import _cfgs, check_runtime_matches_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b",
                                  "musicgen-large"])
def test_runtime_matches_reference(name):
    check_runtime_matches_reference(name)


def test_vlm_training_is_refused_in_both_packages():
    """The parties' synthetic batches carry no image embeddings: the
    reference fails at its first local step (its cross-attention projects
    None), the port refuses the config with a ValueError that says so."""
    jcfg, cfg = _cfgs("llama-3.2-vision-90b")

    def spec(cls, pcls):
        return cls(job_id="vlm", model_arch=cfg.name, model_bytes=1 << 20,
                   rounds=1, lr=0.05, batch_size=8,
                   parties={f"p{i}": pcls(f"p{i}") for i in range(2)})

    kw = dict(n_sequences=16, eval_sequences=8, seed=0)
    with pytest.raises(ValueError):
        JPlatform().train(jcfg, spec(JFLJobSpec, JPartySpec), **kw)
    with pytest.raises(ValueError, match="image_embeds"):
        Platform().train(cfg, spec(FLJobSpec, PartySpec), device="cpu", **kw)
    assert jconfigs.get_config("llama-3.2-vision-90b").num_image_tokens
