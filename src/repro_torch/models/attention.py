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
from repro_torch.models.sharding_ctx import (constrain, contract, head_local,
                                             is_dtensor, opt_feature, write,
                                             write_slot)
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
    if is_dtensor(q):  # each rank its sequences and heads
        k, v = _kv_per_head(q, k, v)  # (as chunked_causal_attn left them)
        bh = (0, 2)
        return head_local(_grouped_attn, (q.shape[2], k.shape[2]),
                          (bh, bh, bh, (None, None)), (bh,), q, k, v, mask)
    b, sq, h, d = q.shape
    probs = torch.softmax(_scores(q, k, mask), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def _scores(q, k, mask):
    """The masked fp32 scores (B, KV, G, Sq, Sk) of ``_grouped_attn``."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    return torch.where(mask[None, None, None], scores, NEG_INF)


def _keys_split(k) -> bool:
    """Whether the DTensor ``k`` (B, Sk, KV, D) is split along its keys."""
    from torch.distributed.tensor import Shard

    return any(p == Shard(1) for p in k.placements)


def _split_key_attn(q, k, v, mask):
    """``_grouped_attn`` on DTensors whose keys are split along their
    sequence (a decode cache over ``cache_seq``, or a sequence-parallel
    step's K/V), as the reference's partitioner computes it: a softmax
    distributed over the key blocks. Where K/V are split on the sequence,
    each rank takes the queries whole (a gather where they are split), the
    mask's block of keys, and its own keys: the largest score is
    all-reduced by max, the softmax's denominator and the product with V
    by sum. Where K/V are split on the batch and so are the queries, each
    rank takes its sequences; any other dim is taken whole. The softmax is
    the plain one's (the scores less their maximum, exponentiated, over
    their sum, in fp32, then cast), the sums taken block by block; each
    stage recomputes its block's scores. The maximum only shifts the
    exponent, so no gradient flows through it; a whole operand's gradient
    is a partial sum over the key blocks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    rep, b0, s1 = Replicate(), Shard(0), Shard(1)
    if not is_dtensor(mask):  # positions every rank computes alike
        mask = DTensor.from_local(mask, mesh, (rep,) * mesh.ndim,
                                  run_check=False)
    qp, kp, mp, stat, part, whole, grad = [], [], [], [], [], [], []
    for pk, pq, n in zip(k.placements, getattr(q, "placements",
                                               (rep,) * mesh.ndim),
                         mesh.shape):
        if pk == s1:  # keys split: partial results, reduced
            blk = (rep, pk, pk, Partial("max"), Partial(), rep, Partial())
        elif pk == b0 and pq == b0 and q.shape[0] % n == 0:  # sequences
            blk = (b0, b0, rep, b0, b0, b0, b0)
        else:
            blk = (rep,) * 7
        for acc, pl in zip((qp, kp, mp, stat, part, whole, grad), blk):
            acc.append(pl)
    qp, kp, mp, stat, part, whole, grad = map(
        tuple, (qp, kp, mp, stat, part, whole, grad))
    s_out = tuple(Partial() if p == Partial("max") else p for p in stat)

    def run(fn, out_pl, in_pl, grad_pl, *args):
        return local_map(fn, out_placements=(out_pl,), in_placements=in_pl,
                         in_grad_placements=grad_pl, redistribute_inputs=True,
                         device_mesh=mesh)(*args)

    with torch.no_grad():
        top = run(lambda q_, k_, m_: _scores(q_, k_, m_).amax(
            -1, keepdim=True), stat, (qp, kp, mp), (grad, kp, mp), q, k, mask)
        top = top.redistribute(mesh, whole)
    den = run(lambda q_, k_, m_, t_: torch.exp(_scores(q_, k_, m_) - t_).sum(
        -1, keepdim=True), s_out, (qp, kp, mp, whole), (grad, kp, mp, whole),
        q, k, mask, top)
    den = den.redistribute(mesh, whole)

    def product(q_, k_, v_, m_, t_, d_):
        probs = (torch.exp(_scores(q_, k_, m_) - t_) / d_).to(q_.dtype)
        b, sq, h, d = q_.shape
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_)
        return out.reshape(b, sq, h, d)

    out = run(product, part, (qp, kp, kp, mp, whole, whole),
              (grad, kp, kp, mp, whole, grad), q, k, v, mask, top, den)
    return out.redistribute(mesh, whole)


def _queries_whole(q, k):
    """The DTensor ``q`` whole along its sequence wherever the keys ``k``
    are split along theirs: one gather a layer, after which each chunk of
    queries is a local slice."""
    from torch.distributed.tensor import Replicate, Shard

    return q.redistribute(q.device_mesh, tuple(
        Replicate() if pk == Shard(1) else pq
        for pq, pk in zip(q.placements, k.placements)))


def _kv_per_head(q, k, v):
    """On DTensors, each rank's K/V heads for its query heads, where the
    query heads are split over a mesh dim that the KV heads do not divide
    (8 KV heads over a 16-way model axis): DTensor cannot split that dim
    into (KV heads, group) as the grouped einsum's reshape asks, while the
    reference's partitioner tiles the pair. Each rank takes, from the
    whole K/V, head i // group for each of its query heads i, so the
    scores are the same; the gradient of the whole K/V is then a partial
    sum over the ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    h, kvh = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    split = [i for i, (p, n) in enumerate(zip(q.placements, mesh.shape))
             if p == Shard(2) and kvh % n]
    if kvh == h or not split:
        return k, v
    (dim,) = split  # one mesh dim splits the heads (the model axis)
    n, g = mesh.shape[dim], h // kvh
    j = mesh.get_coordinate()[dim]
    pl = tuple(Replicate() if i == dim else p
               for i, p in enumerate(k.placements))
    out = tuple(Shard(2) if i == dim else p for i, p in enumerate(pl))
    grad = tuple(Partial() if i == dim else p for i, p in enumerate(pl))

    def heads(t):
        idx = torch.arange(j * (h // n), (j + 1) * (h // n),
                           device=t.device) // g
        return t[:, :, idx]

    def per_head(t):
        return local_map(heads, out_placements=(out,), in_placements=(pl,),
                         in_grad_placements=(grad,), redistribute_inputs=True,
                         device_mesh=mesh)(t)

    return per_head(k), per_head(v)


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
    attn = _grouped_attn
    if is_dtensor(k) and _keys_split(k):  # a sequence-parallel step's K/V
        attn = _split_key_attn
        q = _queries_whole(q, k)  # once for every chunk
    elif is_dtensor(q):  # once for every chunk
        k, v = _kv_per_head(q, k, v)
    outs = []
    for s0 in range(0, sq, q_chunk):
        pc = q_positions[s0:s0 + q_chunk]
        mask = k_positions[None, :] <= pc[:, None]
        if window is not None:
            mask &= (pc[:, None] - k_positions[None, :]) < window
        outs.append(attn(q[:, s0:s0 + q_chunk], k, v, mask))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# block application (projections + rope + cache handling)
# --------------------------------------------------------------------------
def _project_qkv(cfg: ModelConfig, p, x):
    q = contract("bsd,dhk->bshk", x, p["wq"])
    k = contract("bsd,dhk->bshk", x, p["wk"], follow="h")
    v = contract("bsd,dhk->bshk", x, p["wv"], follow="h")
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
    if cfg.rotary:
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
            write(cache["k"], k[:, s - cap:])
            write(cache["v"], v[:, s - cap:])
            write(cache["pos"], positions[s - cap:])
        else:  # the rest of the slots: zeros, marked invalid
            for name, new in (("k", k), ("v", v)):
                cache[name][:, :s].copy_(new)
                cache[name][:, s:].zero_()
            cache["pos"][:s].copy_(positions)
            cache["pos"][s:].fill_(-1)
    else:  # single-token decode against the ring buffer
        cap = cache["k"].shape[1]
        slot = torch.remainder(t, cap).reshape(1).long()
        write_slot(cache["k"], 1, slot, k)
        write_slot(cache["v"], 1, slot, v)
        cpos = cache["pos"]
        write_slot(cpos, 0, slot, t.reshape(1).to(cpos.dtype))
        valid = (cpos >= 0) & (cpos <= t)
        if window is not None:
            valid &= (t - cpos) < window
        attn = (_split_key_attn if is_dtensor(cache["k"])
                and _keys_split(cache["k"]) else _grouped_attn)
        out = attn(q, cache["k"], cache["v"], valid[None, :])

    y = contract("bshk,hkd->bsd", out, p["wo"])
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
    q = contract("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if cache is not None and kv_embeds is None:
        k, v = cache["k"], cache["v"]
    else:
        k = contract("bpd,dhk->bphk", kv_embeds, p["wk"], follow="h")
        v = contract("bpd,dhk->bphk", kv_embeds, p["wv"], follow="h")
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cache is not None:
            write(cache["k"], k)
            write(cache["v"], v)
    mask = torch.ones((1, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _grouped_attn(q, k, v, mask)
    return contract("bshk,hkd->bsd", out, p["wo"]), cache


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
