"""Plain PyTorch versions of the fusion kernels (``src/repro/kernels/ref.py``
line for line): fp32 math, then a cast to the reference's output dtype.

The kernel wrappers take these only for tensors on the CPU; on the card they
are what ``chip_smoke.py`` holds each kernel against. They accept the
kernels' launch shape (``bn``, ``kb``) and ignore it."""
from __future__ import annotations

from typing import Optional

import torch


def fused_agg_ref(updates: torch.Tensor, weights: torch.Tensor, *,
                  bn: Optional[int] = None, kb: Optional[int] = None
                  ) -> torch.Tensor:
    """updates: (K, N); weights: (K,) -> (N,) weighted sum in fp32."""
    return torch.einsum(
        "k,kn->n", weights.to(torch.float32), updates.to(torch.float32)
    ).to(updates.dtype)


def pair_fuse_ref(a: torch.Tensor, b: torch.Tensor, op: str, wa: float = 0.5,
                  wb: float = 0.5, *, bn: Optional[int] = None,
                  kb: Optional[int] = None) -> torch.Tensor:
    """The paper's coordinate-wise pairwise fusion f(M1[i], M2[i])."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    if op == "mean":
        out = 0.5 * (a32 + b32)
    elif op == "wsum":
        out = wa * a32 + wb * b32
    elif op == "max":
        out = torch.maximum(a32, b32)
    elif op == "min":
        out = torch.minimum(a32, b32)
    else:
        raise ValueError(op)
    return out.to(a.dtype)


def quant_agg_ref(q: torch.Tensor, scales: torch.Tensor, *,
                  bn: Optional[int] = None, kb: Optional[int] = None
                  ) -> torch.Tensor:
    """q: (K, N) int8; scales: (K,) fp32 -> (N,) fp32 dequantised weighted sum."""
    return torch.einsum("k,kn->n", scales, q.to(torch.float32))
