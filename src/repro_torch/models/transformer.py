"""Decoder stages built from the config's block pattern, looping over the
stacked layer parameters (the reference scans them), with optional remat.

Block types (the ones this port carries so far)
  attn   : RMSNorm -> self-attn (full causal)      -> +res ; RMSNorm -> MLP -> +res
  moe    : RMSNorm -> self-attn -> +res ; RMSNorm -> MoE FFN -> +res  (+aux)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import Pytree, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_apply, mlp_specs, rms_norm, rms_norm_spec
from repro_torch.models.spec import stack_specs


# --------------------------------------------------------------------------
# per-block specs
# --------------------------------------------------------------------------
def block_param_specs(cfg: ModelConfig, btype: str) -> Dict[str, Pytree]:
    if btype not in ("attn", "moe"):
        raise ValueError(f"block type {btype!r} is not ported")
    d = cfg.d_model
    return {
        "ln1": rms_norm_spec(d),
        "attn": attn.attn_specs(cfg),
        "ln2": rms_norm_spec(d),
        "ffn": (moe_mod.moe_specs(cfg) if btype == "moe"
                else mlp_specs(d, cfg.d_ff)),
    }


# --------------------------------------------------------------------------
# per-block application
# --------------------------------------------------------------------------
def block_apply(cfg: ModelConfig, btype: str, p: Dict[str, Pytree],
                x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux): aux is the MoE router's load-balance loss, 0 for
    an attn block."""
    if btype not in ("attn", "moe"):
        raise ValueError(f"block type {btype!r} is not ported")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p["attn"], h, positions)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if btype == "moe":
        y, aux = moe_mod.moe_apply(cfg, p["ffn"], h)
    else:
        y = mlp_apply(p["ffn"], h)
    return x + y, aux


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the super-block ``reps`` times, layer r reading slice r of the
    stacked parameters. Returns (x, the blocks' aux losses summed)."""

    def body(h, p_r):
        aux_r = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, bt in enumerate(pattern):
            h, aux = block_apply(cfg, bt, p_r[f"b{i}_{bt}"], h, positions)
            aux_r = aux_r + aux
        return h, aux_r

    remat = training and cfg.remat == "full" and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(reps):
        p_r = tree_map(lambda t: t[r], params)
        if remat:
            x, aux = checkpoint(body, x, p_r, use_reentrant=False)
        else:
            x, aux = body(x, p_r)
        aux_sum = aux_sum + aux
    return x, aux_sum
