"""The paper's pairwise coordinate-wise fusion operator

    M1 (+) M2 = [f(M1[1], M2[1]), ..., f(M1[n], M2[n])]

used by incremental (streaming) aggregation, where updates are fused one
pair at a time as they arrive. f is one of mean, weighted sum, max, min.

On the card this launches the hand-written CUDA kernel ``csrc/pair_fuse.cu``
(it replaces the Pallas kernel ``src/repro/kernels/pair_fuse.py:46``; the
source says what bounds it and how it is built for that) at the launch shape
``bn`` / ``kb`` (``build.launch_shape``; None is the kernel's default,
``build.DEFAULT_SHAPES``). A
tensor on the CPU takes the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pair_fuse_ref

OPS = {"mean": 0, "wsum": 1, "max": 2, "min": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pair_fuse(a: torch.Tensor, b: torch.Tensor, *, op: str = "mean",
              wa: float = 0.5, wb: float = 0.5, bn: Optional[int] = None,
              kb: Optional[int] = None) -> torch.Tensor:
    """o = f(a, b) elementwise over two (N,) vectors, math in fp32, output
    in ``a``'s dtype. ``a`` and ``b`` may differ in dtype (fp32 or bf16).
    ``bn`` / ``kb``: elements a block owns and elements a thread."""
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"pair_fuse takes two (N,) vectors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return pair_fuse_many([a], [b], op=op, wa=wa, wb=wb, bn=bn, kb=kb)[0]


pair_fuse.launches = 0  # kernel launches since the last reset


def pair_fuse_many(a_list: Sequence[torch.Tensor],
                   b_list: Sequence[torch.Tensor], *, op: str = "mean",
                   wa: float = 0.5, wb: float = 0.5, bn: Optional[int] = None,
                   kb: Optional[int] = None) -> List[torch.Tensor]:
    """``pair_fuse`` of each pair ``(a_list[i], b_list[i])``: two tensors of
    one shape (any rank), each result in its ``a``'s shape and dtype. On the
    card each pair is one launch of the same kernel, the largest pairs
    first, made from one loop that looks up the library, the stream and the
    launch shape once and reshapes nothing, so a fold costs the host a
    fraction of what a ``pair_fuse`` call a leaf costs and a small model's
    fold is bound by the card more than by the host, whose speed drifts
    (PERF.md section 6).
    Tensors on the CPU take the plain version pair by pair."""
    if op not in OPS:
        raise ValueError(op)
    vec, threads = build.launch_shape("pair_fuse", bn, kb)
    if len(a_list) != len(b_list):
        raise ValueError(f"{len(a_list)} left operands, {len(b_list)} right")
    if not a_list:
        return []
    dev = a_list[0].device

    def check(a: torch.Tensor, b: torch.Tensor) -> None:
        if a.shape != b.shape:
            raise ValueError(f"pair_fuse takes pairs of one shape, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        if a.device != dev or b.device != dev:
            raise ValueError(f"operands on {a.device} and {b.device}, not "
                             f"all on {dev}")

    if dev.type == "cpu":
        for a, b in zip(a_list, b_list):
            check(a, b)
        return [pair_fuse_ref(a.reshape(-1), b.reshape(-1), op, wa,
                              wb).reshape(a.shape)
                for a, b in zip(a_list, b_list)]
    if dev.type != "cuda":
        raise ValueError(f"pair_fuse runs on cuda or cpu, not {dev}")
    fn = build.library("pair_fuse").pair_fuse_launch
    code, wa, wb = OPS[op], float(wa), float(wb)
    outs: List[Optional[torch.Tensor]] = [None] * len(a_list)
    # the largest pairs first: the card then holds most of the work while
    # the host launches the small pairs, which take it little time
    order = sorted(range(len(a_list)), key=lambda i: -a_list[i].numel())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in order:
            a, b = a_list[i], b_list[i]
            check(a, b)
            if a.dtype not in DTYPES or b.dtype not in DTYPES:
                raise TypeError(f"pair_fuse takes fp32/bf16, got {a.dtype}, "
                                f"{b.dtype}")
            if not (a.is_contiguous() and b.is_contiguous()):
                raise ValueError("pair_fuse takes contiguous operands")
            out = outs[i] = torch.empty_like(a)
            n = a.numel()
            if n == 0:
                continue
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, code,
                     DTYPES[a.dtype], DTYPES[b.dtype], wa, wb, vec, threads,
                     stream)
            build.check("pair_fuse", err)
            pair_fuse.launches += 1
    return outs
