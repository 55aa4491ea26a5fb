"""The launch-shape search of the hand-written CUDA fusion kernels
(``csrc/``), and the port's ``KernelCostTable``: t_pair by kernel and model
size, measured on the card, which prices the simulation vehicles' fuse work
(``Platform(cost_table=...)``, ``AggregationEstimator(cost_table=...)``).

The counterpart of ``src/repro/kernels/autotune.py``. The table
(``CostEntry``, ``KernelCostTable``) keeps the reference's fields,
interpolation and JSON layout, so a table dumped by either package loads in
the other and gives the same ``t_pair`` at any size. The search keeps the
reference's functions (``candidates``, ``grid_steps``, ``modeled_time_s``,
``TileChoice``, ``autotune``) with CUDA meanings:

  * **The launch shape** is (V elements a thread, T threads a block), one of
    the fixed set every library exports (``build.SHAPES``, 3 x 4 pairs;
    defaults ``build.DEFAULT_SHAPES``: 4 x 256 for pair_fuse, 8 x 256 for
    fused_agg and quant_agg). It rides in the reference's tile fields: ``bn`` is
    the elements a block owns (V x T, the TPU tile's elements) and ``kb``
    the elements a thread (V), so T = bn / kb. K, the updates one launch
    fuses, is not recorded: it is ``KERNELS[kernel].k`` (2 for pair_fuse,
    8 for fused_agg and quant_agg; the reference's default ``kb`` for
    fused_agg; for quant_agg the reference's 32 is the TPU's int8 sublane
    tile, which the CUDA kernel does not have).
  * **The byte model** (``kernel_bytes_moved``) does not depend on the
    shape. Each block owns V x T elements of N and loops over all K rows in
    registers, so every input byte is read once and every output byte
    written once: no K-slab revisits of the output and no padding (the TPU
    kernels pad to their tile and revisit the fp32 output once per K slab).
  * **Legality** (``candidates``): every operand moves in whole vectors, a
    thread's span of each (V x its itemsize) 8, 16, 32 or 64 bytes (one
    8-byte vector, or one to four 16-byte vectors); and no block larger than
    the problem padded to the smallest such block.
  * **The score** (``modeled_time_s``): ``roofline.bandwidth_time_s`` of the
    bytes over the H100's memory rate, plus the blocks times a per-block
    allowance (``BLOCK_S``), plus a per-launch host cost (``LAUNCH_S``).
    The closed-form ``autotune`` runs anywhere and never launches a kernel.
  * ``build_cost_table(basis="measured")`` searches on the card: it times
    every legal shape with CUDA events (``measure``: eager launches, and
    the same launches replayed as one CUDA graph, which leaves out the
    host's launch cost) and records the shape whose device time is least,
    with its eager time. From a model of 50 MB up (the simulated fleets'
    sizes), each launch moves more than the 50 MB L2 and so finds its
    operands cold, as an aggregator does. ``basis="roofline"`` prices each
    entry from the byte model over the memory rate, at the closed-form
    choice.

The per-pair share of one ``fused_agg`` or ``quant_agg`` launch over K
updates is its time over K - 1, as in the reference.

    python -m repro_torch.kernels.autotune --basis measured --out table.json
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels.build import SHAPES, default_tile
from repro_torch.launch.mesh import H100, HardwareSpec
from repro_torch.launch.roofline import bandwidth_time_s

#: bytes a thread may move of one operand: one 8-byte vector, or one to
#: four 16-byte vectors
LEGAL_SPANS = (8, 16, 32, 64)
#: modeled per-block cost (``fit_block_s`` over the search's rows) and
#: per-launch host cost (``measure_overheads``), both measured by
#: chip_smoke.py phase 13 on an NVIDIA H100 80GB HBM3 at 700 W: the
#: per-block fit read -0.074, -0.089 and -0.10 ns a block in three runs,
#: each within the runs' spread, and 17.9 and 36.6 us a launch in two (the
#: host is shared with other work). The per-block cost is floored at 0: a
#: negative one would score more blocks faster and pick the smallest legal
#: block, which the measured search never keeps from 29 M elements up. At
#: 0 every legal shape moves the same bytes and scores the same, so the
#: closed-form choice is the default shape; what a thread moves (4, 8 or
#: 16 elements) matters more, which only the measured search sees.
BLOCK_S = 0.0
LAUNCH_S = 17.86e-6
#: timed launches per measurement, after WARMUP untimed ones
ITERS = 10
WARMUP = 3


@dataclasses.dataclass(frozen=True)
class KernelShapeSpec:
    """What the byte model needs of one kernel at the table's operands."""

    in_itemsize: int  # bytes per update element
    out_itemsize: int  # bytes per output element
    k: int  # updates fused by one launch


KERNELS: Dict[str, KernelShapeSpec] = {
    # fp32 accumulator + fp32 update -> fp32 (wsum)
    "pair_fuse": KernelShapeSpec(4, 4, 2),
    # K fp32 rows + (K,) fp32 weights -> fp32
    "fused_agg": KernelShapeSpec(4, 4, 8),
    # K int8 rows + (K,) fp32 scales -> fp32
    "quant_agg": KernelShapeSpec(1, 4, 8),
}


def _itemsizes(kernel: str, update_itemsize: Optional[int]) -> Tuple[int, ...]:
    """Itemsizes of the operands a thread moves: pair_fuse's fp32
    accumulator and output and its update; fused_agg's updates and output
    (the updates' dtype); quant_agg's int8 rows and fp32 output."""
    u = KERNELS[kernel].in_itemsize if update_itemsize is None else update_itemsize
    if kernel == "pair_fuse":
        return (4, u)
    if kernel == "fused_agg":
        return (u,)
    return (1, 4)


def kernel_bytes_moved(kernel: str, k: int, n: int,
                       update_itemsize: Optional[int] = None) -> int:
    """Bytes one launch must move over n elements: each input byte read
    once, each output byte written once, at every launch shape.
    ``pair_fuse`` reads two vectors (an fp32 accumulator and the update)
    and writes one fp32 vector (k is ignored); ``fused_agg`` and
    ``quant_agg`` read K rows and K fp32 weights and write one row (in the
    updates' dtype, fp32 for quant_agg). ``update_itemsize`` defaults to
    the table's (``KERNELS``)."""
    spec = KERNELS[kernel]
    u = spec.in_itemsize if update_itemsize is None else update_itemsize
    if kernel == "pair_fuse":
        return n * spec.out_itemsize + n * u + n * spec.out_itemsize
    out = u if kernel == "fused_agg" else spec.out_itemsize
    return k * n * u + n * out + 4 * k


def roofline_s(kernel: str, k: int, n: int,
               update_itemsize: Optional[int] = None) -> float:
    """The least time one launch can take: its bytes over the card's memory
    rate (all three kernels do at most 2 flops per byte read)."""
    return bandwidth_time_s(
        kernel_bytes_moved(kernel, k, n, update_itemsize), H100)


def _pairs(kernel: str, k: int) -> int:
    return 1 if kernel == "pair_fuse" else max(k - 1, 1)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def grid_steps(kernel: str, k: int, n: int, *, bn: int, kb: int) -> int:
    """Blocks one launch runs at shape (bn, kb): each owns bn elements of N
    and loops over all K rows itself."""
    return -(-max(n, 1) // bn)


def modeled_time_s(kernel: str, k: int, n: int, *, bn: int, kb: int,
                   hw: HardwareSpec = H100,
                   update_itemsize: Optional[int] = None) -> float:
    """The search's score: bandwidth roofline of the bytes, plus the blocks
    times BLOCK_S, plus LAUNCH_S."""
    bts = kernel_bytes_moved(kernel, k, n, update_itemsize)
    steps = grid_steps(kernel, k, n, bn=bn, kb=kb)
    return bandwidth_time_s(bts, hw) + steps * BLOCK_S + LAUNCH_S


@dataclasses.dataclass(frozen=True)
class TileChoice:
    kernel: str
    k: int
    n: int
    bn: int  # elements a block owns
    kb: int  # elements a thread
    bytes_moved: int
    roofline_s: float  # bytes / hbm_bw at the scoring HardwareSpec
    modeled_s: float  # roofline_s + blocks and launch (the score)


def candidates(kernel: str, k: int, n: int,
               update_itemsize: Optional[int] = None
               ) -> List[Tuple[int, int]]:
    """Legal (bn, kb) pairs for one kernel x shape: every operand in whole
    vectors (a thread's span of each in LEGAL_SPANS), no block larger than
    the problem padded to the kernel's smallest such block."""
    sizes = _itemsizes(kernel, update_itemsize)
    whole = [(vec * threads, vec) for vec, threads in SHAPES
             if all(vec * s in LEGAL_SPANS for s in sizes)]
    max_bn = _ceil_to(max(n, 1), min(bn for bn, _ in whole))
    return [(bn, kb) for bn, kb in whole if bn <= max_bn]


def autotune(kernel: str, k: int, n: int, hw: HardwareSpec = H100,
             update_itemsize: Optional[int] = None) -> TileChoice:
    """Pick the (bn, kb) minimising modeled time for one shape, closed-form
    (no kernel runs). Deterministic: ties break toward the default shape,
    then the smaller block, then fewer elements a thread."""
    default = default_tile(kernel)
    best: Optional[Tuple[Tuple[float, bool, int, int], TileChoice]] = None
    for bn, kb in candidates(kernel, k, n, update_itemsize):
        bts = kernel_bytes_moved(kernel, k, n, update_itemsize)
        t = modeled_time_s(kernel, k, n, bn=bn, kb=kb, hw=hw,
                           update_itemsize=update_itemsize)
        key = (t, (bn, kb) != default, bn, kb)
        if best is None or key < best[0]:
            best = (key, TileChoice(kernel, k, n, bn, kb, bts,
                                    bandwidth_time_s(bts, hw), t))
    if best is None:
        raise ValueError(f"no legal launch shape for {kernel} k={k} n={n}")
    return best[1]


# --------------------------------------------------------------------------
# KernelCostTable: (kernel, model_bytes) -> measured/projected t_pair
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostEntry:
    """One measurement: fusing updates of ``model_bytes`` with ``kernel``
    at launch shape (bn, kb) costs ``t_pair_s`` seconds per pair. ``bn`` is
    the elements a block owns and ``kb`` the elements a thread."""

    kernel: str
    model_bytes: int
    t_pair_s: float
    bn: int
    kb: int
    basis: str  # "roofline" (projected) | "measured" (CUDA events)


@dataclasses.dataclass
class KernelCostTable:
    """Measured-hardware §5.4 cost model: t_pair by kernel and model size.

    ``t_pair(model_bytes)`` interpolates linearly in bytes between the
    table's sizes (fusion is bandwidth-bound, hence linear in bytes) and
    scales proportionally beyond either end. JSON round-trips via
    ``dump``/``load`` so a table measured on the card ships to the
    simulator as an artifact.
    """

    entries: List[CostEntry] = dataclasses.field(default_factory=list)
    hw: str = "h100"

    #: the estimator prices the paper's PAIRWISE fusion operator
    DEFAULT_KERNEL = "pair_fuse"

    def kernels(self) -> List[str]:
        return sorted({e.kernel for e in self.entries})

    def _sorted(self, kernel: str) -> List[CostEntry]:
        rows = sorted((e for e in self.entries if e.kernel == kernel),
                      key=lambda e: e.model_bytes)
        if not rows:
            raise KeyError(
                f"cost table has no entries for kernel {kernel!r} "
                f"(has: {self.kernels()})")
        return rows

    def t_pair(self, model_bytes: int,
               kernel: str = DEFAULT_KERNEL) -> float:
        rows = self._sorted(kernel)
        mb = float(max(model_bytes, 1))
        if mb <= rows[0].model_bytes:
            return rows[0].t_pair_s * mb / rows[0].model_bytes
        if mb >= rows[-1].model_bytes:
            return rows[-1].t_pair_s * mb / rows[-1].model_bytes
        for lo, hi in zip(rows, rows[1:]):
            if lo.model_bytes <= mb <= hi.model_bytes:
                f = (mb - lo.model_bytes) / (hi.model_bytes - lo.model_bytes)
                return lo.t_pair_s + f * (hi.t_pair_s - lo.t_pair_s)
        raise AssertionError("unreachable")

    def tile(self, model_bytes: int,
             kernel: str = DEFAULT_KERNEL) -> Tuple[int, int]:
        """The (bn, kb) of the nearest table size."""
        rows = self._sorted(kernel)
        e = min(rows, key=lambda e: abs(e.model_bytes - model_bytes))
        return e.bn, e.kb

    # ---- serialization ----------------------------------------------------
    def to_json(self) -> Dict:
        return {"hw": self.hw,
                "entries": [dataclasses.asdict(e) for e in self.entries]}

    @classmethod
    def from_json(cls, obj: Dict) -> "KernelCostTable":
        return cls(entries=[CostEntry(**e) for e in obj["entries"]],
                   hw=obj.get("hw", "h100"))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "KernelCostTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


@dataclasses.dataclass(frozen=True)
class Measured:
    """One launch shape of one kernel timed on the card (seconds a launch):
    ``eager_s`` the mean of ITERS launches between CUDA events, the host
    launching each; ``graph_s`` the median of REPEATS replays of the same
    ITERS launches captured as one CUDA graph (device time, no host launch
    cost), and ``graph_spread_s`` their range."""

    kernel: str
    n: int
    k: int
    update_itemsize: int
    bn: int
    kb: int
    eager_s: float
    graph_s: float
    graph_spread_s: float

    @property
    def roofline_s(self) -> float:
        return roofline_s(self.kernel, self.k, self.n, self.update_itemsize)


#: graph replays a measurement takes the median of
REPEATS = 3


def _launcher(kernel: str, n: int, k: int, device, update_dtype):
    """A function (bn, kb) -> one launch of ``kernel`` over operands drawn
    once on ``device``: pair_fuse folds an update into an fp32 accumulator
    (wsum), fused_agg fuses K updates, quant_agg K int8 rows."""
    import torch

    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg

    gen = torch.Generator(device=device).manual_seed(0)
    if kernel == "pair_fuse":
        a = torch.randn(n, generator=gen, device=device)
        b = torch.randn(n, generator=gen, device=device).to(update_dtype)
        return lambda bn, kb: pair_fuse(a, b, op="wsum", wa=0.5, wb=0.5,
                                        bn=bn, kb=kb)
    if kernel == "fused_agg":
        u = torch.randn(k, n, generator=gen, device=device).to(update_dtype)
        w = torch.full((k,), 1.0 / k, device=device)
        return lambda bn, kb: fused_agg(u, w, bn=bn, kb=kb)
    if kernel == "quant_agg":
        q = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                          dtype=torch.int8)
        s = torch.full((k,), 0.01, device=device)
        return lambda bn, kb: quant_agg(q, s, bn=bn, kb=kb)
    raise ValueError(kernel)


def _time(fn, device) -> Tuple[float, float, float]:
    """(eager, graph median, graph range) seconds a launch of ``fn``."""
    import torch

    with torch.cuda.device(device):
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        eager = start.elapsed_time(end) / 1e3 / ITERS
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                fn()
        graph.replay()
        replays = []
        for _ in range(REPEATS):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            replays.append(start.elapsed_time(end) / 1e3 / ITERS)
        del graph
    return eager, statistics.median(replays), max(replays) - min(replays)


def search(kernel: str, n: int, k: int, device, update_dtype=None
           ) -> List[Measured]:
    """Every legal launch shape of ``kernel`` over n elements (K rows)
    timed on the card (``Measured``), in ``candidates`` order. The
    operands are drawn once; ``update_dtype`` defaults to the table's
    (fp32; int8 rows for quant_agg)."""
    import torch

    if update_dtype is None:
        update_dtype = torch.float32
    usize = 1 if kernel == "quant_agg" else update_dtype.itemsize
    launch = _launcher(kernel, n, k, device, update_dtype)
    shapes = candidates(kernel, k, n, usize)
    # one untimed pass first: right after the caching allocator hands
    # memory back to the driver, the next few milliseconds of launches run
    # slow (PERF.md section 6), and no shape should pay for it
    _time(lambda: launch(*shapes[0]), device)
    rows = []
    for bn, kb in shapes:
        eager, graph, spread = _time(lambda: launch(bn, kb), device)
        rows.append(Measured(kernel, n, k, usize, bn, kb, eager, graph,
                             spread))
    return rows


def best(rows: Sequence[Measured]) -> Measured:
    """The shape whose device time is least (ties: the default shape)."""
    return min(rows, key=lambda r: (r.graph_s,
                                    (r.bn, r.kb) != default_tile(r.kernel)))


def default_of(rows: Sequence[Measured]) -> Optional[Measured]:
    """The default shape's row; None where the default is not legal (a
    problem smaller than its block)."""
    return next((r for r in rows if (r.bn, r.kb) == default_tile(r.kernel)),
                None)


def measure_overheads(device) -> Dict[str, float]:
    """The costs the score adds to the bytes, measured on ``device``:

    ``launch_host_s``: host time of one ``pair_fuse`` call over one
    smallest block (wrapper, ctypes and launch), the mean of 1,000 calls
    on the host clock, unsynchronised (the card keeps up);
    ``launch_device_s``: device time of the same launch, from a CUDA graph
    of ITERS launches."""
    import torch

    from repro_torch.kernels.pair_fuse import pair_fuse

    a = torch.zeros(min(v * t for v, t in SHAPES), device=device)
    fn = lambda: pair_fuse(a, a, op="wsum", wa=0.5, wb=0.5)
    _, device_s, _ = _time(fn, device)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_s = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
    return {"launch_host_s": host_s, "launch_device_s": device_s}


def fit_block_s(rows: Sequence[Measured]) -> float:
    """The per-block allowance the measured rows give: for each (kernel,
    n, K, dtype, elements a thread) with three or more shapes, the
    least-squares slope of device time against the blocks (the bytes and a
    thread's work fixed, only the block size varying); the median of those
    slopes."""
    groups: Dict[Tuple[str, int, int, int, int], List[Measured]] = {}
    for r in rows:
        groups.setdefault((r.kernel, r.n, r.k, r.update_itemsize, r.kb), []
                          ).append(r)
    slopes = []
    for g in groups.values():
        if len(g) < 3:
            continue
        xs = [grid_steps(r.kernel, r.k, r.n, bn=r.bn, kb=r.kb) for r in g]
        ys = [r.graph_s for r in g]
        mx, my = statistics.fmean(xs), statistics.fmean(ys)
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx:
            slopes.append(sum((x - mx) * (y - my)
                              for x, y in zip(xs, ys)) / sxx)
    if not slopes:
        raise ValueError("no group of three or more shapes to fit")
    return statistics.median(slopes)


def build_cost_table(
    model_sizes_bytes: Sequence[int],
    kernels: Sequence[str] = ("pair_fuse", "fused_agg", "quant_agg"),
    *,
    basis: str = "roofline",
    device=None,
    trace: Optional[List[Measured]] = None,
) -> KernelCostTable:
    """One entry per (kernel, model size). n is model_bytes over the
    kernel's input itemsize, as in the reference.

    ``basis="roofline"`` prices each entry from the byte model over the
    memory rate, at the closed-form ``autotune`` choice.
    ``basis="measured"`` searches on ``device`` (the card when None; with
    no card it raises): every legal shape timed (``search``), the entry at
    the shape of least device time with its eager time; every timed shape
    is appended to ``trace`` when given. Each entry's operands are freed
    (to the caching allocator) before the next."""
    if basis not in ("roofline", "measured"):
        raise ValueError(f"basis is 'roofline' or 'measured', not {basis!r}")
    if basis == "measured":
        from repro_torch import get_device

        device = get_device(device)
        if device.type != "cuda":
            raise ValueError(f"basis='measured' times the CUDA kernels; "
                             f"it needs a CUDA device, not {device}")
    entries: List[CostEntry] = []
    for kernel in kernels:
        spec = KERNELS[kernel]
        for mb in sorted(model_sizes_bytes):
            n = max(mb // spec.in_itemsize, 1)
            if basis == "measured":
                rows = search(kernel, n, spec.k, device)
                if trace is not None:
                    trace.extend(rows)
                pick = best(rows)
                bn, kb, t = pick.bn, pick.kb, pick.eager_s
            else:
                choice = autotune(kernel, spec.k, n)
                bn, kb, t = choice.bn, choice.kb, choice.roofline_s
            entries.append(CostEntry(kernel=kernel, model_bytes=int(mb),
                                     t_pair_s=t / _pairs(kernel, spec.k),
                                     bn=bn, kb=kb, basis=basis))
    return KernelCostTable(entries=entries, hw="h100")


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes-mb", default="1,4,16,64,256",
                    help="comma-separated model sizes in MiB")
    ap.add_argument("--basis", choices=("roofline", "measured"),
                    default="roofline",
                    help="roofline: the byte model over the memory rate "
                         "(runs anywhere); measured: CUDA events on the card")
    ap.add_argument("--out", default="kernel_cost_table.json")
    args = ap.parse_args(argv)
    sizes = [int(float(s) * (1 << 20))
             for s in args.sizes_mb.split(",") if s]
    table = build_cost_table(sizes, basis=args.basis)
    table.dump(args.out)
    for e in table.entries:
        print(f"{e.kernel},{e.model_bytes},{e.t_pair_s:.3e},bn={e.bn},"
              f"kb={e.kb},{e.basis}")
    print(f"[wrote {args.out}: {len(table.entries)} entries]")


if __name__ == "__main__":
    main()
