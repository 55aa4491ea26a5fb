"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

Training/prefill uses the chunked SSD algorithm: quadratic attention-like
computation within chunks of length Q, linear recurrence across chunk
states (a loop over the chunks; the reference scans them). Decode is the
O(1) state update. ngroups=1.

The reference's three-operand einsums are contracted in a fixed order
that never materialises a (B, nc, Q, Q, H, P) tensor: the decay factors
are multiplied in elementwise first, then one batched product contracts
the chunk axis. A given cache is written in place (``copy_``), as the
attention cache is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (causal_conv1d, conv1d_step, rms_norm,
                                       rms_norm_spec)
from repro_torch.models.spec import TensorSpec

Cache = Dict[str, torch.Tensor]


def ssm_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.conv_kernel
    if din != h * cfg.ssm_head_dim:
        raise ValueError("d_inner must equal ssm_heads*ssm_head_dim")
    return {
        "w_z": TensorSpec((d, din), ("d_model", "d_inner")),
        "w_x": TensorSpec((d, din), ("d_model", "d_inner")),
        "w_B": TensorSpec((d, n), ("d_model", None)),
        "w_C": TensorSpec((d, n), ("d_model", None)),
        "w_dt": TensorSpec((d, h), ("d_model", "heads")),
        "conv_x": TensorSpec((k, din), (None, "d_inner"), scale=0.5),
        "conv_B": TensorSpec((k, n), (None, None), scale=0.5),
        "conv_C": TensorSpec((k, n), (None, None), scale=0.5),
        "A_log": TensorSpec((h,), ("heads",), init="zeros"),
        "D": TensorSpec((h,), ("heads",), init="ones"),
        "dt_bias": TensorSpec((h,), ("heads",), init="zeros"),
        "norm": rms_norm_spec(din),
        "w_out": TensorSpec((din, d), ("d_inner", "d_model")),
    }


def ssm_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k, din = cfg.conv_kernel, cfg.d_inner
    return {
        "state": TensorSpec((batch, h, pdim, n), ("batch", "heads", None, None),
                            init="zeros", dtype="float32"),
        "conv_x": TensorSpec((batch, k - 1, din), ("batch", None, "d_inner"), init="zeros"),
        "conv_B": TensorSpec((batch, k - 1, n), ("batch", None, None), init="zeros"),
        "conv_C": TensorSpec((batch, k - 1, n), ("batch", None, None), init="zeros"),
    }


def _ssd_chunked(
    x: torch.Tensor,  # (B,S,H,P)  (already multiplied by dt)
    a: torch.Tensor,  # (B,S,H)    log-decay increments (negative)
    bm: torch.Tensor,  # (B,S,N)
    cm: torch.Tensor,  # (B,S,N)
    chunk: int,
    init_state: Optional[torch.Tensor],  # (B,H,P,N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x's dtype, the fp32 state after the last position)."""
    f32 = torch.float32
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    nc = s // q
    if nc * q != s:
        raise ValueError(f"seq {s} not divisible by ssm chunk {q}")
    xc = x.reshape(b, nc, q, h, p).to(f32)
    ac = a.reshape(b, nc, q, h)
    bc = bm.reshape(b, nc, q, n)
    cc = cm.reshape(b, nc, q, n)

    cum = torch.cumsum(ac, dim=2)  # inclusive (B,nc,Q,H)

    # intra-chunk (the "quadratic branch"): scores x decay first, then one
    # product over the key axis k for every (b, c, h)
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc).to(f32)
    ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.where(tri[None, None, :, :, None], torch.exp(ldec), 0.0)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * lmat, xc)

    # chunk-boundary states: decay to the chunk's end times x first
    dte = torch.exp(cum[:, :, -1:, :] - cum)  # decay from pos to chunk end
    s_chunk = torch.einsum("bckn,bckhp->bchpn", bc.to(f32),
                           dte[..., None] * xc)
    cdec = torch.exp(cum[:, :, -1, :])  # (B,nc,H) whole-chunk decay

    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    prev = []
    for c in range(nc):  # the state entering each chunk
        prev.append(state)
        state = cdec[:, c, :, None, None] * state + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc.to(f32),
                           prev_states) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssm_apply(
    cfg: ModelConfig,
    prm: Dict[str, torch.Tensor],
    xin: torch.Tensor,  # (B, S, d)
    *,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Training when cache is None; with a cache, S > 1 is a prefill (the
    final state and the last K-1 raw projections are written into it) and
    S == 1 a decode step. Returns (output, the cache written in place)."""
    f32 = torch.float32
    b, s, _ = xin.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim

    z = xin @ prm["w_z"]
    xr = xin @ prm["w_x"]
    br = xin @ prm["w_B"]
    cr = xin @ prm["w_C"]
    dt = (xin @ prm["w_dt"]).to(f32)
    dt = F.softplus(dt + prm["dt_bias"].to(f32))  # (B,S,H)
    a_coef = -torch.exp(prm["A_log"].to(f32))  # (H,)

    if cache is not None and s == 1:  # decode
        xs, conv_x = conv1d_step(xr[:, 0], cache["conv_x"], prm["conv_x"])
        bs_, conv_B = conv1d_step(br[:, 0], cache["conv_B"], prm["conv_B"])
        cs_, conv_C = conv1d_step(cr[:, 0], cache["conv_C"], prm["conv_C"])
        xs, bs_, cs_ = F.silu(xs), F.silu(bs_), F.silu(cs_)
        xh = xs.reshape(b, h, pdim).to(f32)
        dt0 = dt[:, 0]  # (B,H)
        dec = torch.exp(a_coef[None] * dt0)  # (B,H)
        db = dt0[:, :, None, None] * torch.einsum("bhp,bn->bhpn", xh,
                                                  bs_.to(f32))
        state = dec[:, :, None, None] * cache["state"] + db
        y = torch.einsum("bhpn,bn->bhp", state, cs_.to(f32))
        y = y + prm["D"].to(f32)[None, :, None] * xh
        y = y.reshape(b, 1, h * pdim).to(xin.dtype)
        for key, new in (("state", state), ("conv_x", conv_x),
                         ("conv_B", conv_B), ("conv_C", conv_C)):
            cache[key].copy_(new)
    else:
        xs = F.silu(causal_conv1d(xr, prm["conv_x"]))
        bs_ = F.silu(causal_conv1d(br, prm["conv_B"]))
        cs_ = F.silu(causal_conv1d(cr, prm["conv_C"]))
        xh = xs.reshape(b, s, h, pdim)
        a = a_coef[None, None, :] * dt  # (B,S,H)
        xdt = xh.to(f32) * dt[..., None]
        y, final_state = _ssd_chunked(
            xdt.to(xin.dtype), a, bs_, cs_, cfg.ssm_chunk,
            cache["state"] if cache is not None else None)
        y = y.to(f32) + prm["D"].to(f32)[None, None, :, None] * xh.to(f32)
        y = y.reshape(b, s, h * pdim).to(xin.dtype)
        if cache is not None:  # prefill: the state and the raw conv tails
            k = cfg.conv_kernel
            cache["state"].copy_(final_state)
            cache["conv_x"].copy_(xr[:, s - (k - 1):, :])
            cache["conv_B"].copy_(br[:, s - (k - 1):, :])
            cache["conv_C"].copy_(cr[:, s - (k - 1):, :])

    y = rms_norm(y * F.silu(z.to(f32)).to(y.dtype), prm["norm"], cfg.norm_eps)
    return y @ prm["w_out"], cache
