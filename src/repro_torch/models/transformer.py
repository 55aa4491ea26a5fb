"""Decoder stages built from the config's block pattern, looping over the
stacked layer parameters (the reference scans them), with optional remat.

Block types
  attn   : RMSNorm -> self-attn (full causal)      -> +res ; RMSNorm -> MLP -> +res
  lattn  : same, sliding-window (cfg.sliding_window)
  xattn  : RMSNorm -> cross-attn over image/frame embeddings -> +res ; MLP
  moe    : RMSNorm -> self-attn -> +res ; RMSNorm -> MoE FFN -> +res  (+aux)
  rglru  : RMSNorm -> RG-LRU recurrent block -> +res ; RMSNorm -> MLP -> +res
  ssm    : RMSNorm -> mamba2/SSD block -> +res      (no separate MLP)

A stage's cache is stacked like its parameters; layer r reads and writes
slice r of it in place (a view), where the reference's scan re-stacks the
whole cache every step. So every block writes its new state into its
cache's tensors (``copy_``): a rebound dict entry would be lost.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import Pytree, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp_apply, mlp_specs, rms_norm, rms_norm_spec
from repro_torch.models.spec import stack_specs


# --------------------------------------------------------------------------
# per-block specs
# --------------------------------------------------------------------------
def block_param_specs(cfg: ModelConfig, btype: str) -> Dict[str, Pytree]:
    d = cfg.d_model
    s: Dict[str, Pytree] = {"ln1": rms_norm_spec(d)}
    if btype in ("attn", "lattn", "moe"):
        s["attn"] = attn.attn_specs(cfg)
        s["ln2"] = rms_norm_spec(d)
        s["ffn"] = (moe_mod.moe_specs(cfg) if btype == "moe"
                    else mlp_specs(d, cfg.d_ff))
    elif btype == "xattn":
        s["xattn"] = attn.attn_specs(cfg)
        s["ln2"] = rms_norm_spec(d)
        s["ffn"] = mlp_specs(d, cfg.d_ff)
    elif btype == "rglru":
        s["rglru"] = rglru_mod.rglru_specs(cfg)
        s["ln2"] = rms_norm_spec(d)
        s["ffn"] = mlp_specs(d, cfg.d_ff)
    elif btype == "ssm":
        s["ssm"] = ssm_mod.ssm_specs(cfg)
    else:
        raise ValueError(f"unknown block type {btype}")
    return s


def block_cache_specs(
    cfg: ModelConfig, btype: str, batch: int, capacity: int
) -> Dict[str, Pytree]:
    if btype in ("attn", "moe"):
        return attn.attn_cache_specs(cfg, batch, capacity)
    if btype == "lattn":
        cap = min(capacity, cfg.sliding_window or capacity)
        return attn.attn_cache_specs(cfg, batch, cap)
    if btype == "xattn":
        return attn.xattn_cache_specs(cfg, batch)
    if btype == "rglru":
        return rglru_mod.rglru_cache_specs(cfg, batch)
    if btype == "ssm":
        return ssm_mod.ssm_cache_specs(cfg, batch)
    raise ValueError(btype)


# --------------------------------------------------------------------------
# per-block application
# --------------------------------------------------------------------------
def block_apply(
    cfg: ModelConfig,
    btype: str,
    p: Dict[str, Pytree],
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    image_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns (x, cache, aux): the block's cache, written in place (None
    without one), and the MoE router's load-balance loss, 0 for the other
    blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if btype in ("attn", "lattn", "moe"):
        window = cfg.sliding_window if btype == "lattn" else None
        y, new_cache = attn.self_attention(cfg, p["attn"], h, positions,
                                           window=window, cache=cache, t=t)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if btype == "moe":
            y, aux = moe_mod.moe_apply(cfg, p["ffn"], h)
        else:
            y = mlp_apply(p["ffn"], h)
        x = x + y
    elif btype == "xattn":
        y, new_cache = attn.cross_attention(cfg, p["xattn"], h, image_embeds,
                                            cache)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h)
    elif btype == "rglru":
        y, new_cache = rglru_mod.rglru_apply(cfg, p["rglru"], h, cache=cache)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h)
    elif btype == "ssm":
        y, new_cache = ssm_mod.ssm_apply(cfg, p["ssm"], h, cache=cache)
        x = x + y
    else:
        raise ValueError(btype)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# stage (loop over repeats of the block pattern)
# --------------------------------------------------------------------------
def stage_param_specs(cfg: ModelConfig, pattern, reps: int) -> Pytree:
    one = {f"b{i}_{bt}": block_param_specs(cfg, bt) for i, bt in enumerate(pattern)}
    return stack_specs(one, reps)


def stage_cache_specs(cfg: ModelConfig, pattern, reps: int, batch: int,
                      capacity: int) -> Pytree:
    one = {
        f"b{i}_{bt}": block_cache_specs(cfg, bt, batch, capacity)
        for i, bt in enumerate(pattern)
    }
    return stack_specs(one, reps)


def stage_apply(
    cfg: ModelConfig,
    pattern,
    reps: int,
    params: Pytree,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    cache: Optional[Pytree] = None,
    image_embeds: Optional[torch.Tensor] = None,
    training: bool = False,
) -> Tuple[torch.Tensor, Optional[Pytree], torch.Tensor]:
    """Apply the super-block ``reps`` times, layer r reading slice r of the
    stacked parameters and of the stacked cache. Returns (x, cache, the
    blocks' aux losses summed); the cache is ``cache``, written in place."""

    def body(h, p_r, c_r):
        aux_r = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, bt in enumerate(pattern):
            key = f"b{i}_{bt}"
            h, _, aux = block_apply(
                cfg, bt, p_r[key], h, positions=positions, t=t,
                cache=c_r[key] if c_r is not None else None,
                image_embeds=image_embeds)
            aux_r = aux_r + aux
        return h, aux_r

    remat = training and cfg.remat == "full" and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(reps):
        p_r = tree_map(lambda a: a[r], params)
        c_r = tree_map(lambda a: a[r], cache) if cache is not None else None
        if remat:
            x, aux = checkpoint(body, x, p_r, c_r, use_reentrant=False)
        else:
            x, aux = body(x, p_r, c_r)
        aux_sum = aux_sum + aux
    return x, cache, aux_sum
