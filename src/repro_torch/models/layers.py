"""Common layers: RMSNorm, RoPE, SwiGLU MLP."""
from __future__ import annotations

from typing import Dict

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
