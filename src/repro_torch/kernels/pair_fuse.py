"""The paper's pairwise coordinate-wise fusion operator

    M1 (+) M2 = [f(M1[1], M2[1]), ..., f(M1[n], M2[n])]

used by incremental (streaming) aggregation, where updates are fused one
pair at a time as they arrive. f is one of mean, weighted sum, max, min.

On the card this launches the hand-written CUDA kernel ``csrc/pair_fuse.cu``
(it replaces the Pallas kernel ``src/repro/kernels/pair_fuse.py:46``; the
source says what bounds it and how it is built for that) at the launch shape
``bn`` / ``kb`` (``build.launch_shape``; None is the kernel's default,
``build.DEFAULT_SHAPES``). One launch fuses a table of up to ``TABLE_MAX``
pairs of one dtype pair, which ``plan`` lays out. A tensor on the CPU takes
the plain version in ``ref.py``.
"""
from __future__ import annotations

import array
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pair_fuse_ref

OPS = {"mean": 0, "wsum": 1, "max": 2, "min": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most pairs one launch takes: csrc/pair_fuse.cu TABLE_MAX
TABLE_MAX = 64


class Operands(NamedTuple):
    """What ``plan`` needs of one pair: dtypes, elements and the addresses
    of ``a``, ``b`` and the output (in ``a``'s dtype)."""
    a_dtype: torch.dtype
    b_dtype: torch.dtype
    n: int
    a: int
    b: int
    out: int


class Entry(NamedTuple):
    """One row of a launch's table."""
    pair: int  # the pair's index in the call
    first: int  # the pair's first block in the grid
    vector: bool  # a, b and out all aligned to the kernel's vector moves


class Launch(NamedTuple):
    dtypes: Tuple[torch.dtype, torch.dtype]
    entries: Tuple[Entry, ...]
    blocks: int  # the grid


def _chunk_bytes(itemsize: int, vec: int) -> int:
    """Bytes of the widest vector a thread moves: csrc/common.cuh
    ``chunk_bytes``."""
    return min(vec * itemsize, 16)


def plan(pairs: Sequence[Operands], vec: int, threads: int) -> List[Launch]:
    """The launches that fuse ``pairs`` at the launch shape (``vec``
    elements a thread, ``threads`` a block): the pairs grouped by (``a``
    dtype, ``b`` dtype) in the order each group first appears, each group
    ordered largest first (ties in call order) and cut into tables of at
    most ``TABLE_MAX``; in a table each pair's blocks follow the last's, and
    a pair takes vector moves when all three of its addresses are aligned to
    them. Empty pairs take no launch."""
    groups: Dict[Tuple[torch.dtype, torch.dtype], List[int]] = {}
    for i, p in enumerate(pairs):
        if p.n:
            groups.setdefault((p.a_dtype, p.b_dtype), []).append(i)
    per_block = vec * threads
    launches = []
    for (da, db), idx in groups.items():
        idx.sort(key=lambda i: -pairs[i].n)
        ca = _chunk_bytes(da.itemsize, vec)
        cb = _chunk_bytes(db.itemsize, vec)
        for c in range(0, len(idx), TABLE_MAX):
            entries, blocks = [], 0
            for i in idx[c:c + TABLE_MAX]:
                p = pairs[i]
                entries.append(Entry(i, blocks, p.a % ca == 0 and
                                     p.b % cb == 0 and p.out % ca == 0))
                blocks += -(-p.n // per_block)
            launches.append(Launch((da, db), tuple(entries), blocks))
    return launches


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
pair_fuse.pairs = 0  # pairs those launches fused


def pair_fuse_many(a_list: Sequence[torch.Tensor],
                   b_list: Sequence[torch.Tensor], *, op: str = "mean",
                   wa: float = 0.5, wb: float = 0.5, bn: Optional[int] = None,
                   kb: Optional[int] = None) -> List[torch.Tensor]:
    """``pair_fuse`` of each pair ``(a_list[i], b_list[i])``: two tensors of
    one shape (any rank), each result in its ``a``'s shape and dtype. Every
    pair is checked before anything launches. On the card one launch fuses
    every pair of a dtype pair (``plan``; up to ``TABLE_MAX`` a launch,
    the largest first), so a model's fold is one launch whatever its
    number of leaves, with no gap between kernels and no ramp-up and drain
    a leaf (PERF.md section 6). Tensors on the CPU take the plain version
    pair by pair."""
    if op not in OPS:
        raise ValueError(op)
    vec, threads = build.launch_shape("pair_fuse", bn, kb)
    if len(a_list) != len(b_list):
        raise ValueError(f"{len(a_list)} left operands, {len(b_list)} right")
    if not a_list:
        return []
    dev = a_list[0].device
    for a, b in zip(a_list, b_list):
        if a.shape != b.shape:
            raise ValueError(f"pair_fuse takes pairs of one shape, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        if a.device != dev or b.device != dev:
            raise ValueError(f"operands on {a.device} and {b.device}, not "
                             f"all on {dev}")
    if dev.type == "cpu":
        return [pair_fuse_ref(a.reshape(-1), b.reshape(-1), op, wa,
                              wb).reshape(a.shape)
                for a, b in zip(a_list, b_list)]
    if dev.type != "cuda":
        raise ValueError(f"pair_fuse runs on cuda or cpu, not {dev}")
    for a, b in zip(a_list, b_list):
        if a.dtype not in DTYPES or b.dtype not in DTYPES:
            raise TypeError(f"pair_fuse takes fp32/bf16, got {a.dtype}, "
                            f"{b.dtype}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("pair_fuse takes contiguous operands")
    fn = build.library("pair_fuse").pair_fuse_table_launch
    code, wa, wb = OPS[op], float(wa), float(wb)
    outs = [torch.empty_like(a) for a in a_list]
    pairs = [Operands(a.dtype, b.dtype, a.numel(), a.data_ptr(),
                      b.data_ptr(), o.data_ptr())
             for a, b, o in zip(a_list, b_list, outs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan(pairs, vec, threads):
            rows = array.array("q")  # the kernel's table, int64 rows
            for e in launch.entries:
                p = pairs[e.pair]
                rows.extend((p.a, p.b, p.out, p.n, e.first, e.vector))
            da, db = launch.dtypes
            err = fn(rows.buffer_info()[0], len(launch.entries), code,
                     DTYPES[da], DTYPES[db], wa, wb, vec, threads, stream)
            build.check("pair_fuse", err)
            pair_fuse.launches += 1
            pair_fuse.pairs += len(launch.entries)
    return outs
