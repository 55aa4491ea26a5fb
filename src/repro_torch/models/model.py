"""Top-level model: embeddings -> staged decoder -> head, and the training
loss. Everything is a function of (cfg, params, batch)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import Pytree, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm, rms_norm_spec
from repro_torch.models.spec import TensorSpec, count_params, init_params


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def _apply_dtype(cfg: ModelConfig, specs: Pytree) -> Pytree:
    """Propagate cfg.dtype to every default-bf16 spec leaf."""

    def fix(s: TensorSpec) -> TensorSpec:
        if s.dtype == "bfloat16" and cfg.dtype != "bfloat16":
            return dataclasses.replace(s, dtype=cfg.dtype)
        return s

    return tree_map(fix, specs)


def param_specs(cfg: ModelConfig) -> Dict[str, Pytree]:
    if cfg.num_codebooks:
        raise ValueError("multi-codebook (audio) models are not ported")
    d, v = cfg.d_model, cfg.vocab_size
    s: Dict[str, Pytree] = {
        "embed": TensorSpec((v, d), ("vocab", "d_model"), scale=1.0),
        "lm_head": TensorSpec((d, v), ("d_model", "vocab")),
    }
    for i, (pattern, reps) in enumerate(cfg.stages()):
        s[f"stage{i}"] = tfm.stage_param_specs(cfg, pattern, reps)
    s["final_norm"] = rms_norm_spec(d)
    return _apply_dtype(cfg, s)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: Pytree,
    tokens: torch.Tensor,
    *,
    training: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (fp32 logits, aux_loss)."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    h = F.embedding(tokens, params["embed"])
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, (pattern, reps) in enumerate(cfg.stages()):
        h, aux = tfm.stage_apply(cfg, pattern, reps, params[f"stage{i}"], h,
                                 positions=positions, training=training)
        aux_total = aux_total + aux
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).to(torch.float32)
    return logits, aux_total


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def loss_fn(
    cfg: ModelConfig, params: Pytree, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(cfg, params, batch["tokens"], training=True)
    labels = batch["labels"]
    # logsumexp minus the label logit; gathering the label logit reads the
    # same value the reference's one-hot contraction sums to, without a
    # (B, S, V) one-hot
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(logz - label_logit)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# --------------------------------------------------------------------------
# convenience
# --------------------------------------------------------------------------
def init(cfg: ModelConfig, gen: torch.Generator) -> Pytree:
    """Random parameters on the generator's device."""
    return init_params(gen, param_specs(cfg))


def n_params(cfg: ModelConfig) -> int:
    return count_params(param_specs(cfg))
