"""The paper's pairwise coordinate-wise fusion operator

    M1 (+) M2 = [f(M1[1], M2[1]), ..., f(M1[n], M2[n])]

used by incremental (streaming) aggregation, where updates are fused one
pair at a time as they arrive. f is one of mean, weighted sum, max, min.

On the card this launches the hand-written CUDA kernel ``csrc/pair_fuse.cu``
(it replaces the Pallas kernel ``src/repro/kernels/pair_fuse.py:46``; the
source says what bounds it and how it is built for that). A tensor on the
CPU takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pair_fuse_ref

OPS = {"mean": 0, "wsum": 1, "max": 2, "min": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pair_fuse(a: torch.Tensor, b: torch.Tensor, *, op: str = "mean",
              wa: float = 0.5, wb: float = 0.5) -> torch.Tensor:
    """o = f(a, b) elementwise over two (N,) vectors, math in fp32, output
    in ``a``'s dtype. ``a`` and ``b`` may differ in dtype (fp32 or bf16)."""
    if op not in OPS:
        raise ValueError(op)
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"pair_fuse takes two (N,) vectors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return pair_fuse_ref(a, b, op, wa, wb)
    if a.device.type != "cuda":
        raise ValueError(f"pair_fuse runs on cuda or cpu, not {a.device}")
    if a.dtype not in DTYPES or b.dtype not in DTYPES:
        raise TypeError(f"pair_fuse takes fp32/bf16, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pair_fuse takes contiguous operands")
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    lib = build.library("pair_fuse")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.pair_fuse_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, OPS[op],
            DTYPES[a.dtype], DTYPES[b.dtype], float(wa), float(wb), stream)
    build.check("pair_fuse", err)
    pair_fuse.launches += 1
    return out


pair_fuse.launches = 0  # kernel launches since the last reset
