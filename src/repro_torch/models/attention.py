"""GQA causal self-attention, training path (no KV cache).

Full-sequence attention is computed over query chunks so the (Sq, Sk) score
matrix is never fully materialised — peak transient is
(B, KV, G, q_chunk, Sk) in fp32. GQA is computed with a grouped einsum (no
head replication of K/V). The scores are fp32, masked with -1e30, and the
probabilities are cast to q's dtype, as in the reference."""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm, rms_norm_spec, rope
from repro_torch.models.spec import TensorSpec

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
    q_chunk: int = 256,
) -> torch.Tensor:
    """Causal attention, computed over chunks of q_chunk queries."""
    sq = q.shape[1]
    if sq % q_chunk and sq > q_chunk:
        raise ValueError(f"seq {sq} not divisible by q_chunk {q_chunk}")
    outs = []
    for s0 in range(0, sq, q_chunk):
        pc = q_positions[s0:s0 + q_chunk]
        mask = k_positions[None, :] <= pc[:, None]
        outs.append(_grouped_attn(q[:, s0:s0 + q_chunk], k, v, mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# block application (projections + rope)
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
) -> torch.Tensor:
    """Causal self attention over the whole sequence (training)."""
    q, k, v = _project_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = chunked_causal_attn(q, k, v, positions, positions)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
