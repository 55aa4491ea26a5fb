"""The ``KernelCostTable`` of the port: t_pair by kernel and model size,
measured on the card through the hand-written CUDA fusion kernels
(``csrc/``), which prices the simulation vehicles' fuse work
(``Platform(cost_table=...)``, ``AggregationEstimator(cost_table=...)``).

The counterpart of ``src/repro/kernels/autotune.py``. The table
(``CostEntry``, ``KernelCostTable``) keeps the reference's fields,
interpolation and JSON layout, so a table dumped by either package loads in
the other and gives the same ``t_pair`` at any size. What differs is what
prices it:

  * **The byte model** (``kernel_bytes_moved``) is that of the CUDA
    kernels. Each block owns one 2,048-element slab of N and loops over all
    K rows in registers, so every input byte is read once and every output
    byte written once: no K-slab revisits of the output and no padding
    (the TPU kernels pad to their tile and revisit the fp32 output once per
    K slab).
  * ``basis="roofline"`` is that byte model over the H100's memory rate,
    pure arithmetic that runs anywhere.
  * ``basis="measured"`` launches the kernels on the card and times them
    with CUDA events. From a model of 50 MB up (the simulated fleets'
    sizes), each launch moves more than the 50 MB L2 and so finds its
    operands cold, as an aggregator does.

The per-pair share of one ``fused_agg`` or ``quant_agg`` launch over K
updates is its time over K - 1, as in the reference. K is 8 for both: the
reference's default ``kb`` for ``fused_agg``; for ``quant_agg`` the
reference's 32 is the TPU's int8 sublane tile, which the CUDA kernel does
not have. The CUDA kernels have one launch shape (256 threads of 8
elements), so there is no tile search here; each entry records K in ``kb``
and the 2,048-element slab in ``bn``.

    python -m repro_torch.kernels.autotune --basis measured --out table.json
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

#: H100 SXM memory rate, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
#: elements one block of each kernel owns (csrc/common.cuh: 256 x 8)
SLAB = 2048
#: timed launches per measured entry, after WARMUP untimed ones
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


def kernel_bytes_moved(kernel: str, k: int, n: int) -> int:
    """Bytes one launch must move over n elements: each input byte read
    once, each output byte written once. ``pair_fuse`` reads two fp32
    vectors and writes one (k is ignored); ``fused_agg`` and ``quant_agg``
    read K rows and K fp32 weights and write one fp32 row."""
    spec = KERNELS[kernel]
    if kernel == "pair_fuse":
        return 2 * n * spec.in_itemsize + n * spec.out_itemsize
    return k * n * spec.in_itemsize + n * spec.out_itemsize + 4 * k


def roofline_s(kernel: str, k: int, n: int) -> float:
    """The least time one launch can take: its bytes over the memory rate
    (all three kernels do at most 2 flops per byte read)."""
    return kernel_bytes_moved(kernel, k, n) / HBM_BYTES_PER_S


def _pairs(kernel: str, k: int) -> int:
    return 1 if kernel == "pair_fuse" else max(k - 1, 1)


# --------------------------------------------------------------------------
# KernelCostTable: (kernel, model_bytes) -> measured/projected t_pair
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostEntry:
    """One measurement: fusing updates of ``model_bytes`` with ``kernel``
    costs ``t_pair_s`` seconds per pair. ``bn`` is the elements a block
    owns and ``kb`` the updates one launch fuses."""

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


def _measure_pair_s(kernel: str, n: int, k: int, device) -> float:
    """Seconds per pair of one kernel launch over n elements on the card:
    the mean of ITERS launches between two CUDA events, after WARMUP."""
    import torch

    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg

    gen = torch.Generator(device=device).manual_seed(0)
    if kernel == "pair_fuse":
        a = torch.randn(n, generator=gen, device=device)
        b = torch.randn(n, generator=gen, device=device)
        fn = lambda: pair_fuse(a, b, op="wsum", wa=0.5, wb=0.5)
    elif kernel == "fused_agg":
        u = torch.randn(k, n, generator=gen, device=device)
        w = torch.full((k,), 1.0 / k, device=device)
        fn = lambda: fused_agg(u, w)
    elif kernel == "quant_agg":
        q = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                          dtype=torch.int8)
        s = torch.full((k,), 0.01, device=device)
        fn = lambda: quant_agg(q, s)
    else:
        raise ValueError(kernel)
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
    t = start.elapsed_time(end) / 1e3 / ITERS
    return t / _pairs(kernel, k)


def build_cost_table(
    model_sizes_bytes: Sequence[int],
    kernels: Sequence[str] = ("pair_fuse", "fused_agg", "quant_agg"),
    *,
    basis: str = "roofline",
    device=None,
) -> KernelCostTable:
    """One entry per (kernel, model size). n is model_bytes over the
    kernel's input itemsize, as in the reference.

    ``basis="roofline"`` prices each entry from the byte model over the
    memory rate. ``basis="measured"`` launches the CUDA kernels on
    ``device`` (the card when None; with no card it raises) and frees each
    entry's operands before the next."""
    if basis not in ("roofline", "measured"):
        raise ValueError(f"basis is 'roofline' or 'measured', not {basis!r}")
    if basis == "measured":
        import torch

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
                t_pair = _measure_pair_s(kernel, n, spec.k, device)
                torch.cuda.empty_cache()
            else:
                t_pair = roofline_s(kernel, spec.k, n) / _pairs(kernel, spec.k)
            entries.append(CostEntry(kernel=kernel, model_bytes=int(mb),
                                     t_pair_s=t_pair, bn=SLAB, kb=spec.k,
                                     basis=basis))
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
