"""GQA attention: causal self-attention (full or sliding-window) with a
KV cache, and cross-attention over a fixed set of image tokens.

Full-sequence attention is computed over query chunks so the (Sq, Sk) score
matrix is never fully materialised — peak transient is
(B, KV, G, q_chunk, Sk) in fp32. GQA is computed with a grouped einsum (no
head replication of K/V). The scores are fp32, masked with -1e30, and the
probabilities are cast to q's dtype, as in the reference.

The cache is written in place. The reference builds a new cache each step
(``dynamic_update_slice`` into a donated buffer); here prefill copies K/V
into the cache's slots and a decode step writes its one slot through a
device index, so a step moves B x KV x D per layer and never waits on the
host. A caller who still needs the old cache passes a copy.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm, rms_norm_spec, rope
from repro_torch.models.sharding_ctx import constrain, opt_feature
from repro_torch.models.spec import TensorSpec

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def attn_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: Dict[str, TensorSpec] = {
        "wq": TensorSpec((d, h, hd), ("d_model", "heads", None)),
        "wk": TensorSpec((d, kv, hd), ("d_model", "kv_heads", None)),
        "wv": TensorSpec((d, kv, hd), ("d_model", "kv_heads", None)),
        "wo": TensorSpec((h, hd, d), ("heads", None, "d_model")),
    }
    if cfg.qkv_bias:
        s["bq"] = TensorSpec((h, hd), ("heads", None), init="zeros")
        s["bk"] = TensorSpec((kv, hd), ("kv_heads", None), init="zeros")
        s["bv"] = TensorSpec((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = rms_norm_spec(hd)
        s["k_norm"] = rms_norm_spec(hd)
    return s


# --------------------------------------------------------------------------
# core grouped attention
# --------------------------------------------------------------------------
def _grouped_attn(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    mask: torch.Tensor,  # (Sq, Sk) bool; True = attend
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def chunked_causal_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,  # (Sq,)
    k_positions: torch.Tensor,  # (Sk,)
    window: Optional[int] = None,
    q_chunk: int = 256,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, computed over chunks of
    q_chunk queries."""
    sq = q.shape[1]
    if sq % q_chunk and sq > q_chunk:
        raise ValueError(f"seq {sq} not divisible by q_chunk {q_chunk}")
    outs = []
    for s0 in range(0, sq, q_chunk):
        pc = q_positions[s0:s0 + q_chunk]
        mask = k_positions[None, :] <= pc[:, None]
        if window is not None:
            mask &= (pc[:, None] - k_positions[None, :]) < window
        outs.append(_grouped_attn(q[:, s0:s0 + q_chunk], k, v, mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# block application (projections + rope + cache handling)
# --------------------------------------------------------------------------
def _project_qkv(cfg: ModelConfig, p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def self_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,)
    *,
    window: Optional[int] = None,
    cache: Optional[Cache] = None,
    t: Optional[torch.Tensor] = None,  # 0-d int32: current position (decode)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Self attention. Training when cache is None; with a cache, S > 1
    fills it (prefill) and S == 1 reads and updates the ring buffer
    (decode). The cache's tensors are written in place and returned."""
    q, k, v = _project_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if opt_feature("kv_anchor") and x.shape[1] > 1:
        # §Perf H3: anchor the (small, GQA) K/V sequence-replicated, so that
        # a sequence-parallel residual gathers them once a layer and every
        # chunk's contraction over the key axis stays on its rank
        k = constrain(k, ("batch", None, "kv_heads", None))
        v = constrain(v, ("batch", None, "kv_heads", None))

    if cache is None:
        out = chunked_causal_attn(q, k, v, positions, positions, window=window)
    elif x.shape[1] > 1:  # prefill into the cache
        s = x.shape[1]
        cap = cache["k"].shape[1]
        out = chunked_causal_attn(q, k, v, positions, positions, window=window)
        if cap <= s:
            # windowed (lattn/SWA) caches keep only the last `cap` positions
            cache["k"].copy_(k[:, s - cap:])
            cache["v"].copy_(v[:, s - cap:])
            cache["pos"].copy_(positions[s - cap:])
        else:  # the rest of the slots: zeros, marked invalid
            for name, new in (("k", k), ("v", v)):
                cache[name][:, :s].copy_(new)
                cache[name][:, s:].zero_()
            cache["pos"][:s].copy_(positions)
            cache["pos"][s:].fill_(-1)
    else:  # single-token decode against the ring buffer
        cap = cache["k"].shape[1]
        slot = torch.remainder(t, cap).reshape(1).long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        cpos = cache["pos"]
        cpos.index_copy_(0, slot, t.reshape(1).to(cpos.dtype))
        valid = (cpos >= 0) & (cpos <= t)
        if window is not None:
            valid &= (t - cpos) < window
        out = _grouped_attn(q, cache["k"], cache["v"], valid[None, :])

    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def cross_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d) text stream
    kv_embeds: Optional[torch.Tensor],  # (B, P, d) image/frame embeddings
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Cross attention over a fixed modality-token set (no causal mask).

    With ``kv_embeds``, K/V are projected from them (and, given a cache,
    written into it: the prefill); without, they are read from the cache
    (the decode step, O(P))."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if cache is not None and kv_embeds is None:
        k, v = cache["k"], cache["v"]
    else:
        k = torch.einsum("bpd,dhk->bphk", kv_embeds, p["wk"])
        v = torch.einsum("bpd,dhk->bphk", kv_embeds, p["wv"])
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    mask = torch.ones((1, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _grouped_attn(q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def attn_cache_specs(
    cfg: ModelConfig, batch: int, capacity: int
) -> Dict[str, TensorSpec]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": TensorSpec((batch, capacity, kv, hd), ("batch", "cache_seq", "kv_heads", None)),
        "v": TensorSpec((batch, capacity, kv, hd), ("batch", "cache_seq", "kv_heads", None)),
        "pos": TensorSpec((capacity,), ("cache_seq",), init="zeros", dtype="int32"),
    }


def xattn_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    p = cfg.num_image_tokens
    return {
        "k": TensorSpec((batch, p, kv, hd), ("batch", None, "kv_heads", None)),
        "v": TensorSpec((batch, p, kv, hd), ("batch", None, "kv_heads", None)),
    }
