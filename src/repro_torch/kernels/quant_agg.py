"""int8 dequantise-and-accumulate fusion:

    out[n] = sum_k scales[k] * q[k, n]     (fp32 sum, fp32 out)

Parties may ship int8-quantised updates with one scale per tensor; the
aggregator fuses them without writing the dequantised fp32 updates to device
memory. On the card this launches the hand-written CUDA kernel
``csrc/quant_agg.cu`` (it replaces the Pallas kernel
``src/repro/kernels/quant_agg.py:37``; the source says what bounds it and how
it is built for that) at the launch shape ``bn`` / ``kb``
(``build.launch_shape``; None is the kernel's default,
``build.DEFAULT_SHAPES``). A tensor on the CPU
takes the plain version in ``ref.py``. ``quantize`` is the party side, plain PyTorch as the reference's
is plain ``jnp``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quant_agg_ref


def quant_agg(q: torch.Tensor, scales: torch.Tensor, *,
              bn: Optional[int] = None, kb: Optional[int] = None
              ) -> torch.Tensor:
    """q: (K, N) int8; scales: (K,) fp32 -> (N,) fp32. ``bn`` / ``kb``:
    elements a block owns and elements a thread."""
    vec, threads = build.launch_shape("quant_agg", bn, kb)
    if q.dim() != 2 or q.shape[0] == 0 or scales.shape != (q.shape[0],):
        raise ValueError(f"quant_agg takes (K, N) q and (K,) scales, got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"quant_agg takes int8 q and fp32 scales, got "
                        f"{q.dtype} and {scales.dtype}")
    if q.device != scales.device:
        raise ValueError(f"operands on {q.device} and {scales.device}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quant_agg takes contiguous operands")
    if q.device.type == "cpu":
        return quant_agg_ref(q, scales)
    if q.device.type != "cuda":
        raise ValueError(f"quant_agg runs on cuda or cpu, not {q.device}")
    k, n = q.shape
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    lib = build.library("quant_agg")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.quant_agg_launch(q.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), k, n, vec, threads, stream)
    build.check("quant_agg", err)
    quant_agg.launches += 1
    return out


quant_agg.launches = 0  # kernel launches since the last reset


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation (party side): the flat int8
    ``q`` and a 0-d fp32 scale, ``x ~ q * scale``.

    Both divisions are true fp32 divisions by a tensor on ``x``'s device:
    PyTorch's CUDA division by a Python number multiplies by its reciprocal,
    which can round differently from the reference and from the CPU."""
    x32 = x.to(torch.float32).reshape(-1)
    amax = x32.abs().max()
    scale = amax / torch.full((), 127.0, device=amax.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale
