"""Top-level model: embeddings -> staged decoder -> head; the training loss
and the prefill / decode entry points. Everything is a function of (cfg,
params, batch); the KV cache is written in place (``decode_step``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import Pytree, get_device, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm, rms_norm_spec
from repro_torch.models.spec import DTYPES, TensorSpec, count_params, init_params


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
    d, v = cfg.d_model, cfg.vocab_size
    s: Dict[str, Pytree] = {}
    if cfg.num_codebooks:  # audio: one embedding + head per codebook
        s["embed"] = TensorSpec(
            (cfg.num_codebooks, v, d), (None, "vocab", "d_model"), scale=1.0)
        s["lm_head"] = TensorSpec((cfg.num_codebooks, d, v),
                                  (None, "d_model", "vocab"))
    else:
        s["embed"] = TensorSpec((v, d), ("vocab", "d_model"), scale=1.0)
        s["lm_head"] = TensorSpec((d, v), ("d_model", "vocab"))
    for i, (pattern, reps) in enumerate(cfg.stages()):
        s[f"stage{i}"] = tfm.stage_param_specs(cfg, pattern, reps)
    s["final_norm"] = rms_norm_spec(d)
    return _apply_dtype(cfg, s)


def cache_specs(cfg: ModelConfig, batch: int, capacity: int) -> Dict[str, Pytree]:
    c: Dict[str, Pytree] = {
        "t": TensorSpec((), (), init="zeros", dtype="int32"),
    }
    for i, (pattern, reps) in enumerate(cfg.stages()):
        c[f"stage{i}"] = tfm.stage_cache_specs(cfg, pattern, reps, batch, capacity)
    return _apply_dtype(cfg, c)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: Union[str, torch.device, None] = None) -> Pytree:
    """Zero-initialised cache on ``device``, its position slots marked
    invalid (-1) and ``t`` a 0-d int32 0. The recurrent states (``state``,
    ``h``) are fp32 whatever the config's dtype."""

    def mk(specs, key=None):
        if isinstance(specs, dict):
            return {k: mk(v, k) for k, v in sorted(specs.items())}
        return torch.full(specs.shape, -1 if key == "pos" else 0,
                          dtype=DTYPES[specs.dtype], device=dev)

    dev = get_device(device)
    return mk(cache_specs(cfg, batch, capacity))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.num_codebooks:
        # tokens: (B, S, K) -> sum of per-codebook embeddings, in order
        h = F.embedding(tokens[..., 0], params["embed"][0])
        for k in range(1, cfg.num_codebooks):
            h = h + F.embedding(tokens[..., k], params["embed"][k])
    else:
        h = F.embedding(tokens, params["embed"])
    if cfg.family == "hybrid":  # gemma-style embedding scaling
        # sqrt(d_model) rounded to the embedding's dtype first, as the
        # reference's jnp.asarray(..., h.dtype)
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
        h = h * scale
    return h


def _head(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    if cfg.num_codebooks:
        return torch.einsum("bsd,kdv->bskv", h, params["lm_head"]).to(
            torch.float32)
    return (h @ params["lm_head"]).to(torch.float32)


def forward(
    cfg: ModelConfig,
    params: Pytree,
    tokens: torch.Tensor,
    *,
    image_embeds: Optional[torch.Tensor] = None,
    cache: Optional[Pytree] = None,
    training: bool = False,
) -> Tuple[torch.Tensor, Optional[Pytree], torch.Tensor]:
    """Returns (fp32 logits, cache, aux_loss). Tokens are (B, S), or (B, S,
    K) for a config with K codebooks, whose logits are (B, S, K, V).

    cache None  -> full-sequence training forward (cache None out).
    cache given, S > 1 -> prefill (fills the cache's slots).
    cache given, S == 1 -> single-token decode at position cache["t"].
    A given cache is written in place and returned, ``t`` advanced by S.
    """
    seq = tokens.shape[1]
    t = cache["t"] if cache is not None else None
    if cache is not None and seq == 1:
        positions = t.reshape(1).to(torch.int32)
    else:
        positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    h = _embed(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, (pattern, reps) in enumerate(cfg.stages()):
        c_i = cache[f"stage{i}"] if cache is not None else None
        h, _, aux = tfm.stage_apply(
            cfg, pattern, reps, params[f"stage{i}"], h, positions=positions,
            t=t, cache=c_i, image_embeds=image_embeds, training=training)
        aux_total = aux_total + aux
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _head(cfg, params, h)
    if cache is not None:
        cache["t"].add_(seq)
    return logits, cache, aux_total


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def loss_fn(
    cfg: ModelConfig, params: Pytree, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             image_embeds=batch.get("image_embeds"),
                             training=True)
    labels = batch["labels"]
    # logsumexp minus the label logit; gathering the label logit reads the
    # same value the reference's one-hot contraction sums to, without a
    # (B, S, V) one-hot
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(logz - label_logit)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


@torch.no_grad()
def prefill(
    cfg: ModelConfig,
    params: Pytree,
    tokens: torch.Tensor,
    *,
    image_embeds: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Pytree]:
    """capacity: total cache slots (>= prompt length) reserved for decode;
    defaults to the prompt length (the dry-run decode-shape convention).
    The cache lies on the tokens' device."""
    b, s = tokens.shape[0], tokens.shape[1]
    cache = init_cache(cfg, b, capacity or s, tokens.device)
    logits, cache, _ = forward(cfg, params, tokens,
                               image_embeds=image_embeds, cache=cache)
    return logits, cache


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params: Pytree,
    cache: Pytree,
    tokens: torch.Tensor,  # (B, 1) or (B, 1, K) for audio
    *,
    image_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Pytree]:
    """One token per sequence at position cache["t"]. Consumes ``cache``:
    its slot, its states and ``t`` are updated in place and the same tree
    is returned (the reference donates it), so pass a copy to keep the old
    one. Cross-attention reads the image K/V the prefill cached unless
    ``image_embeds`` are given again."""
    logits, cache, _ = forward(cfg, params, tokens,
                               image_embeds=image_embeds, cache=cache)
    return logits, cache


# --------------------------------------------------------------------------
# convenience
# --------------------------------------------------------------------------
def init(cfg: ModelConfig, gen: torch.Generator) -> Pytree:
    """Random parameters on the generator's device."""
    return init_params(gen, param_specs(cfg))


def n_params(cfg: ModelConfig) -> int:
    return count_params(param_specs(cfg))


def n_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: routed experts count k/E)."""
    total = 0
    for s in tree_leaves(param_specs(cfg)):
        size = int(math.prod(s.shape))
        if "experts" in (s.axes or ()) and cfg.num_experts:
            size = size * cfg.num_experts_per_tok // cfg.num_experts
        total += size
    return total
