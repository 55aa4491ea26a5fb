"""Common layers: RMSNorm, RoPE, SwiGLU MLP, conv1d."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.spec import TensorSpec


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm_spec(dim: int) -> TensorSpec:
    return TensorSpec((dim,), (None,), init="ones")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., S, H, D); positions: (S,) int.
    """
    d = x.shape[-1]
    half = d // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freq = 1.0 / (theta ** (idx / half))
    ang = positions.to(torch.float32)[:, None] * freq[None, :]  # (S, half)
    cos = torch.cos(ang)[None, :, None, :]  # (1, S, 1, half)
    sin = torch.sin(ang)[None, :, None, :]
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int) -> Dict[str, TensorSpec]:
    return {
        "w_gate": TensorSpec((d_model, d_ff), ("d_model", "d_ff")),
        "w_up": TensorSpec((d_model, d_ff), ("d_model", "d_ff")),
        "w_down": TensorSpec((d_ff, d_model), ("d_ff", "d_model")),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# temporal conv1d (causal, per-channel), used by SSM and RG-LRU blocks
# --------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv along S.

    The K taps are summed one by one in fp32, in tap order, as the
    reference does; ``F.conv1d(groups=C)`` sums in another order, and the
    cast to x's dtype can then round differently."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i:i + s, :].to(torch.float32) * w[i].to(
            torch.float32)
    return out.to(x.dtype)


def conv1d_step(x_t: torch.Tensor, conv_cache: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: (B, C); conv_cache: (B, K-1, C) past inputs.
    Returns (output, the new K-1 past inputs); the taps are summed as in
    ``causal_conv1d``."""
    window = torch.cat([conv_cache, x_t[:, None, :]], dim=1)  # (B, K, C)
    out = torch.zeros(x_t.shape, dtype=torch.float32, device=x_t.device)
    for i in range(w.shape[0]):
        out = out + window[:, i].to(torch.float32) * w[i].to(torch.float32)
    return out.to(x_t.dtype), window[:, 1:, :]
