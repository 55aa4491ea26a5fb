"""N-way weighted fusion of K flattened model updates in one sweep:

    out[n] = sum_k w[k] * updates[k, n]     (fp32 sum, out in updates' dtype)

On the card this launches the hand-written CUDA kernel ``csrc/fused_agg.cu``
(it replaces the Pallas kernel ``src/repro/kernels/fused_agg.py:42``; the
source says what bounds it and how it is built for that). A tensor on the
CPU takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_agg_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """updates: (K, N) fp32 or bf16; weights: (K,) -> (N,) in updates'
    dtype."""
    if (updates.dim() != 2 or updates.shape[0] == 0
            or weights.shape != (updates.shape[0],)):
        raise ValueError(f"fused_agg takes (K, N) updates and (K,) weights, "
                         f"got {tuple(updates.shape)} and "
                         f"{tuple(weights.shape)}")
    if updates.device != weights.device:
        raise ValueError(f"operands on {updates.device} and {weights.device}")
    if updates.device.type == "cpu":
        return fused_agg_ref(updates, weights)
    if updates.device.type != "cuda":
        raise ValueError(f"fused_agg runs on cuda or cpu, not {updates.device}")
    if updates.dtype not in DTYPES:
        raise TypeError(f"fused_agg takes fp32/bf16 updates, got "
                        f"{updates.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"fused_agg takes fp32 weights, got {weights.dtype}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fused_agg takes contiguous operands")
    k, n = updates.shape
    out = torch.empty(n, dtype=updates.dtype, device=updates.device)
    if n == 0:
        return out
    lib = build.library("fused_agg")
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        err = lib.fused_agg_launch(
            updates.data_ptr(), weights.data_ptr(), out.data_ptr(), k, n,
            DTYPES[updates.dtype], stream)
    build.check("fused_agg", err)
    fused_agg.launches += 1
    return out


fused_agg.launches = 0  # kernel launches since the last reset
