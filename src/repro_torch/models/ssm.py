"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

Training/prefill uses the chunked SSD algorithm: quadratic attention-like
computation within chunks of length Q, linear recurrence across chunk
states (a loop over the chunks; the reference scans them). Decode is the
O(1) state update. With ``ssm_groups`` G > 1 (Nemotron-H), B and C are G
groups of the state size, head h reading group h // (H / G), the chunked
SSD runs group by group over its heads, and the gated RMSNorm normalises
each of G groups of d_inner / G; G = 1 is the reference's block. The
convolutions take a bias where ``ssm_conv_bias`` says so.

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
from repro_torch.models.sharding_ctx import (contract, head_local,
                                             is_dtensor, write)
from repro_torch.models.spec import TensorSpec

Cache = Dict[str, torch.Tensor]


def ssm_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    n = cfg.ssm_groups * cfg.ssm_state  # B and C: every group's state
    k = cfg.conv_kernel
    if din != h * cfg.ssm_head_dim:
        raise ValueError("d_inner must equal ssm_heads*ssm_head_dim")
    if h % cfg.ssm_groups:
        raise ValueError("ssm_heads must divide over ssm_groups")
    s = {
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
    if cfg.ssm_conv_bias:
        s["conv_x_bias"] = TensorSpec((din,), ("d_inner",), init="zeros")
        s["conv_B_bias"] = TensorSpec((n,), (None,), init="zeros")
        s["conv_C_bias"] = TensorSpec((n,), (None,), init="zeros")
    return s


def ssm_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k, din = cfg.conv_kernel, cfg.d_inner
    gn = cfg.ssm_groups * n
    return {
        "state": TensorSpec((batch, h, pdim, n), ("batch", "heads", None, None),
                            init="zeros", dtype="float32"),
        "conv_x": TensorSpec((batch, k - 1, din), ("batch", None, "d_inner"), init="zeros"),
        "conv_B": TensorSpec((batch, k - 1, gn), ("batch", None, None), init="zeros"),
        "conv_C": TensorSpec((batch, k - 1, gn), ("batch", None, None), init="zeros"),
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


def _ssd_grouped(x, a, bm, cm, chunk, init_state, groups: int):
    """``_ssd_chunked`` with B and C in ``groups`` groups, bm and cm (B, S,
    G x N): group j's heads, the j-th H / G of them, run against its own
    B and C."""
    if groups == 1:
        return _ssd_chunked(x, a, bm, cm, chunk, init_state)
    hg, n = x.shape[2] // groups, bm.shape[-1] // groups
    ys, states = [], []
    for j in range(groups):
        heads, cols = slice(j * hg, (j + 1) * hg), slice(j * n, (j + 1) * n)
        y, st = _ssd_chunked(
            x[:, :, heads], a[:, :, heads], bm[..., cols], cm[..., cols],
            chunk, None if init_state is None else init_state[:, heads])
        ys.append(y)
        states.append(st)
    return torch.cat(ys, dim=2), torch.cat(states, dim=1)


def _per_head(m: torch.Tensor, heads: int, groups: int) -> torch.Tensor:
    """(B, G x N) -> (B, H, N): each head's group of B or C."""
    b = m.shape[0]
    return m.reshape(b, groups, 1, -1).expand(
        b, groups, heads // groups, m.shape[-1] // groups).reshape(
        b, heads, -1)


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

    def proj(w):
        return contract("bsd,de->bse", xin, w, torch.matmul)

    z = proj(prm["w_z"])
    xr = proj(prm["w_x"])
    br = proj(prm["w_B"])
    cr = proj(prm["w_C"])
    dt = proj(prm["w_dt"]).to(f32)
    dt = F.softplus(dt + prm["dt_bias"].to(f32))  # (B,S,H)
    a_coef = -torch.exp(prm["A_log"].to(f32))  # (H,)

    d_skip = prm["D"]
    g = cfg.ssm_groups
    if g > 1 and is_dtensor(xin):
        raise NotImplementedError("grouped B/C on a mesh: the heads' split "
                                  "does not follow the groups")
    if cache is not None and s == 1:  # decode
        xs, conv_x = conv1d_step(xr[:, 0], cache["conv_x"], prm["conv_x"],
                                 prm.get("conv_x_bias"))
        bs_, conv_B = conv1d_step(br[:, 0], cache["conv_B"], prm["conv_B"],
                                  prm.get("conv_B_bias"))
        cs_, conv_C = conv1d_step(cr[:, 0], cache["conv_C"], prm["conv_C"],
                                  prm.get("conv_C_bias"))
        xs, bs_, cs_ = F.silu(xs), F.silu(bs_), F.silu(cs_)

        def step(xs, dt0, a_coef, d_skip, bs_, cs_, state0):
            b = xs.shape[0]
            h = dt0.shape[1]
            xh = xs.reshape(b, h, pdim).to(f32)
            dec = torch.exp(a_coef[None] * dt0)  # (B,H)
            if g == 1:
                db = torch.einsum("bhp,bn->bhpn", xh, bs_.to(f32))
            else:
                db = torch.einsum("bhp,bhn->bhpn", xh,
                                  _per_head(bs_, h, g).to(f32))
            state = dec[:, :, None, None] * state0 + dt0[:, :, None,
                                                         None] * db
            if g == 1:
                y = torch.einsum("bhpn,bn->bhp", state, cs_.to(f32))
            else:
                y = torch.einsum("bhpn,bhn->bhp", state,
                                 _per_head(cs_, h, g).to(f32))
            y = y + d_skip.to(f32)[None, :, None] * xh
            return y.reshape(b, 1, h * pdim).to(xin.dtype), state

        # (B,H) per head: each rank its sequences and heads
        y, state = head_local(
            step, (h,), ((0, 1), (0, 1), (None, 0), (None, 0), (0, None),
                         (0, None), (0, 1)), ((0, 2), (0, 1)),
            xs, dt[:, 0], a_coef, d_skip, bs_, cs_, cache["state"])
        for key, new in (("state", state), ("conv_x", conv_x),
                         ("conv_B", conv_B), ("conv_C", conv_C)):
            write(cache[key], new)
    else:
        xs = F.silu(causal_conv1d(xr, prm["conv_x"], prm.get("conv_x_bias")))
        bs_ = F.silu(causal_conv1d(br, prm["conv_B"], prm.get("conv_B_bias")))
        cs_ = F.silu(causal_conv1d(cr, prm["conv_C"], prm.get("conv_C_bias")))

        def scan(xs, dt, a_coef, d_skip, bs_, cs_, init):
            b, s = xs.shape[:2]
            h = dt.shape[2]
            xh = xs.reshape(b, s, h, pdim)
            a = a_coef[None, None, :] * dt  # (B,S,H)
            xdt = xh.to(f32) * dt[..., None]
            y, final_state = _ssd_grouped(xdt.to(xin.dtype), a, bs_, cs_,
                                          cfg.ssm_chunk, init, g)
            y = y.to(f32) + d_skip.to(f32)[None, None, :, None] * xh.to(f32)
            return y.reshape(b, s, h * pdim).to(xin.dtype), final_state

        init = cache["state"] if cache is not None else None
        y, final_state = head_local(
            scan, (h,), ((0, 2), (0, 2), (None, 0), (None, 0), (0, None),
                         (0, None), (0, 1) if init is not None else None),
            ((0, 2), (0, 1)), xs, dt, a_coef, d_skip, bs_, cs_, init)
        if cache is not None:  # prefill: the state and the raw conv tails
            k = cfg.conv_kernel
            write(cache["state"], final_state)
            write(cache["conv_x"], xr[:, s - (k - 1):, :])
            write(cache["conv_B"], br[:, s - (k - 1):, :])
            write(cache["conv_C"], cr[:, s - (k - 1):, :])

    y = y * F.silu(z.to(f32)).to(y.dtype)
    if g == 1:
        y = rms_norm(y, prm["norm"], cfg.norm_eps)
    else:  # each group of d_inner / G on its own
        din = y.shape[-1]
        y = rms_norm(y.reshape(b, s, g, din // g),
                     prm["norm"].reshape(g, din // g),
                     cfg.norm_eps).reshape(b, s, din)
    return contract("bse,ed->bsd", y, prm["w_out"], torch.matmul), cache
