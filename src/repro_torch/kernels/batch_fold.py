"""The aggregator's backlog fold, up to ``C_MAX`` updates a pass:

    out = acc + w_0 u_0 + w_1 u_1 + ... + w_{c-1} u_{c-1}

leaf by leaf in fp32, summed in that order with each product and each sum
rounded on its own, so the result is bit for bit that of c streaming folds
(``pair_fuse`` wsum, one update at a time). Without an accumulator the sum
starts at the rounded first product, as the streaming fold's first cast
does.

On the card this launches the hand-written CUDA kernel ``csrc/batch_fold.cu``
(it replaces no TPU kernel; the source says what bounds it and how it is
built for that): one launch folds the batch into a table of up to
``TABLE_MAX`` leaves whose updates share a dtype, which ``plan`` lays out.
Tensors on the CPU take the plain version in ``ref.py``.
"""
from __future__ import annotations

import array
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pair_fuse import DTYPES, Entry, Launch, _chunk_bytes
from repro_torch.kernels.ref import batch_fold_ref

#: the most updates one launch folds: csrc/batch_fold.cu C_MAX
C_MAX = 8
#: the most leaves one launch takes: csrc/batch_fold.cu TABLE_MAX
TABLE_MAX = 256


class Operands(NamedTuple):
    """What ``plan`` needs of one leaf: the updates' dtype, elements, and
    the addresses of the accumulator read (0 when the batch starts it),
    the output and each update."""
    u_dtype: torch.dtype
    n: int
    acc: int
    out: int
    updates: tuple


def plan(leaves: Sequence[Operands], vec: int, threads: int) -> List[Launch]:
    """The launches that fold ``leaves`` at the launch shape (``vec``
    elements a thread, ``threads`` a block): the leaves grouped by their
    updates' dtype in the order each group first appears, each group
    ordered largest first (ties in call order) and cut into tables of at
    most ``TABLE_MAX``; in a table each leaf's blocks follow the last's,
    and a leaf takes vector moves when every address it reads or writes is
    aligned to them. Empty leaves take no launch."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, p in enumerate(leaves):
        if p.n:
            groups.setdefault(p.u_dtype, []).append(i)
    per_block = vec * threads
    ca = _chunk_bytes(4, vec)
    launches = []
    for du, idx in groups.items():
        idx.sort(key=lambda i: -leaves[i].n)
        cu = _chunk_bytes(du.itemsize, vec)
        for c in range(0, len(idx), TABLE_MAX):
            entries, blocks = [], 0
            for i in idx[c:c + TABLE_MAX]:
                p = leaves[i]
                entries.append(Entry(i, blocks, p.acc % ca == 0 and
                                     p.out % ca == 0 and
                                     all(u % cu == 0 for u in p.updates)))
                blocks += -(-p.n // per_block)
            launches.append(Launch((torch.float32, du), tuple(entries),
                                   blocks))
    return launches


def batch_fold(acc: Optional[Sequence[torch.Tensor]],
               updates: Sequence[Sequence[torch.Tensor]],
               weights: Sequence[float], *, in_place: bool = False,
               bn: Optional[int] = None,
               kb: Optional[int] = None) -> List[torch.Tensor]:
    """Fold the ``c = len(updates)`` updates (1 to ``C_MAX``, each a list of
    leaves in ``acc``'s order and shapes) with ``weights`` into the fp32
    accumulator leaves ``acc``, or start one when ``acc`` is None; returns
    the fp32 leaves. ``in_place`` writes into ``acc``'s own leaves (only an
    accumulator no one else holds may be updated so); otherwise new ones
    are made. Two updates may be the same tensor; none may share memory
    with ``acc``. Everything is checked before any launch. On the card one
    launch folds every leaf (``plan``: up to ``TABLE_MAX`` leaves a launch
    and update dtype); ``bn`` / ``kb`` choose the launch shape
    (``build.launch_shape``). Tensors on the CPU take the plain version
    leaf by leaf."""
    c = len(updates)
    if not 1 <= c <= C_MAX or len(weights) != c:
        raise ValueError(f"batch_fold takes 1 to {C_MAX} updates with a "
                         f"weight each, got {c} and {len(weights)} weights")
    if in_place and acc is None:
        raise ValueError("batch_fold in place needs an accumulator")
    vec, threads = build.launch_shape("batch_fold", bn, kb)
    leaves = len(updates[0])
    if any(len(u) != leaves for u in updates) or \
            acc is not None and len(acc) != leaves:
        raise ValueError("batch_fold takes updates and an accumulator of "
                         "one number of leaves")
    if not leaves:
        return []
    dev = updates[0][0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"batch_fold runs on cuda or cpu, not {dev}")
    card = dev.type == "cuda"
    ops = []
    for i in range(leaves):  # one pass over every operand, then the launch
        u0 = updates[0][i]
        shape, du = u0.shape, u0.dtype
        if card and du not in DTYPES:
            raise TypeError(f"batch_fold takes fp32/bf16 updates, got {du}")
        ptrs = []
        for u in updates:
            t = u[i]
            if t.shape != shape or t.device != dev:
                raise ValueError(f"batch_fold takes leaves of one shape and "
                                 f"device, got {tuple(t.shape)} on "
                                 f"{t.device} and {tuple(shape)} on {dev}")
            if card and (t.dtype != du or not t.is_contiguous()):
                raise TypeError(f"batch_fold takes contiguous updates of one "
                                f"dtype a leaf, got {t.dtype} and {du}")
            ptrs.append(t.data_ptr())
        lo = 0
        if acc is not None:
            a = acc[i]
            if a.shape != shape or a.device != dev:
                raise ValueError(f"batch_fold takes an accumulator of its "
                                 f"updates' shapes, got {tuple(a.shape)} on "
                                 f"{a.device} and {tuple(shape)} on {dev}")
            if card and (a.dtype != torch.float32 or not a.is_contiguous()):
                raise TypeError(f"batch_fold takes a contiguous fp32 "
                                f"accumulator, got {a.dtype}")
            lo, hi = a.data_ptr(), a.data_ptr() + a.nbytes
            if a.nbytes and any(lo < p + u[i].nbytes and p < hi
                                for p, u in zip(ptrs, updates)):
                raise ValueError("an update shares memory with the "
                                 "accumulator")
        ops.append(Operands(du, u0.numel(), lo, 0, tuple(ptrs)))
    if not card:
        out = []
        for i in range(leaves):
            a = None if acc is None else acc[i]
            got = batch_fold_ref(a, [u[i] for u in updates], weights)
            out.append(a.copy_(got) if in_place else got)
        return out
    fn = build.library("batch_fold").batch_fold_table_launch
    outs = (list(acc) if in_place else
            [torch.empty(u.shape, dtype=torch.float32, device=dev)
             for u in updates[0]])
    ops = [p._replace(out=o.data_ptr()) for p, o in zip(ops, outs)]
    w = array.array("f", weights)
    pad = (0,) * (C_MAX - c)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan(ops, vec, threads):
            rows = array.array("q")  # the kernel's table, int64 rows
            for e in launch.entries:
                p = ops[e.pair]
                rows.extend((p.acc, p.out, *p.updates, *pad, p.n, e.first,
                             e.vector))
            err = fn(rows.buffer_info()[0], len(launch.entries),
                     w.buffer_info()[0], c, int(acc is None),
                     DTYPES[launch.dtypes[1]], vec, threads, stream)
            build.check("batch_fold", err)
            batch_fold.launches += 1
            batch_fold.updates += c
    return outs


batch_fold.launches = 0  # kernel launches since the last reset
batch_fold.updates = 0  # updates those launches folded, c a launch
