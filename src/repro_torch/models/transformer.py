"""Decoder stages built from the config's block pattern, looping over the
stacked layer parameters (the reference scans them), with optional remat.

Block type (the one this port carries so far)
  attn   : RMSNorm -> self-attn (full causal)      -> +res ; RMSNorm -> MLP -> +res
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import Pytree, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_specs, rms_norm, rms_norm_spec
from repro_torch.models.spec import stack_specs


# --------------------------------------------------------------------------
# per-block specs
# --------------------------------------------------------------------------
def block_param_specs(cfg: ModelConfig, btype: str) -> Dict[str, Pytree]:
    if btype != "attn":
        raise ValueError(f"block type {btype!r} is not ported")
    d = cfg.d_model
    return {
        "ln1": rms_norm_spec(d),
        "attn": attn.attn_specs(cfg),
        "ln2": rms_norm_spec(d),
        "ffn": mlp_specs(d, cfg.d_ff),
    }


# --------------------------------------------------------------------------
# per-block application
# --------------------------------------------------------------------------
def block_apply(cfg: ModelConfig, btype: str, p: Dict[str, Pytree],
                x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if btype != "attn":
        raise ValueError(f"block type {btype!r} is not ported")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["attn"], h, positions)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h)


# --------------------------------------------------------------------------
# stage (loop over repeats of the block pattern)
# --------------------------------------------------------------------------
def stage_param_specs(cfg: ModelConfig, pattern, reps: int) -> Pytree:
    one = {f"b{i}_{bt}": block_param_specs(cfg, bt) for i, bt in enumerate(pattern)}
    return stack_specs(one, reps)


def stage_apply(
    cfg: ModelConfig,
    pattern,
    reps: int,
    params: Pytree,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    training: bool = False,
) -> torch.Tensor:
    """Apply the super-block ``reps`` times, layer r reading slice r of the
    stacked parameters."""

    def body(h, p_r):
        for i, bt in enumerate(pattern):
            h = block_apply(cfg, bt, p_r[f"b{i}_{bt}"], h, positions)
        return h

    remat = training and cfg.remat == "full" and torch.is_grad_enabled()
    for r in range(reps):
        p_r = tree_map(lambda t: t[r], params)
        if remat:
            x = checkpoint(body, x, p_r, use_reentrant=False)
        else:
            x = body(x, p_r)
    return x
