"""Beyond-paper: the paper's aggregation (§5.4 t_agg) mapped onto a device
mesh: N-way weighted fusion of full-size model updates with the flattened
update sharded over every mesh axis (the JAX package's
``benchmarks/dist_agg.py``).

Fusion is coordinate-wise, so each rank fuses its own (K, P / ranks) block
of the update stack through the ``fused_agg`` kernel (``fuse_sharded``) and
no rank talks to another: the run counts the collectives with
``CommDebugMode`` around the rank-local fusion and asserts there are none,
as the reference asserts its compiled fusion has none.

  analytic rows  (``run_one``, any device) the reference's row for its
                 256-rank production layout (16 x 16): params, K, the bytes
                 a rank moves (K reads + 1 write of its padded share, fp32)
                 and the paper's CPU aggregation of 1000 updates (t_pair =
                 3 M / 10 GB/s on a 2-vCPU container), computed as the
                 reference computes them; the reference's TPU roofline
                 columns become ``t_agg_gpu_ms`` and ``t_agg_gpu_1000p_s``,
                 the same bytes over one H100's 3.35 TB/s. ``collectives``
                 is counted around the fusion of a stand-in stack on one
                 process (``tests/test_torch_shard_ranks.py`` counts it
                 on 2 x 2 gloo ranks).
  measured       (``measure``, the card only) one rank's fusion of K fp32
                 updates at the model's full size (world size 1: the whole
                 flattened update), held against ``fused_agg_ref`` on the
                 card, timed with CUDA events beside its bound.

  python -m repro_torch.benchmarks.dist_agg [--device cpu]
      [--measure ARCH]

CSV: arch,params,k_updates,bytes_per_chip,t_agg_gpu_ms,t_agg_gpu_1000p_s,
     t_agg_cpu_1000p_s,collectives
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
from typing import Dict, List, Optional

import torch

from repro_torch import configs, get_device
from repro_torch.kernels.fused_agg import fused_agg
from repro_torch.kernels.ref import fused_agg_ref
from repro_torch.launch.mesh import H100
from repro_torch.launch.sharding import NamedSharding
from repro_torch.models import model as M
from repro_torch.models.sharding_ctx import mesh_sizes

CPU_EFF_BW = 10e9  # the strategy sim's 2-vCPU fusion bandwidth
PRODUCTION = {"data": 16, "model": 16}  # the reference's 256-chip layout
STAND_IN = 1024  # elements of the stand-in stack whose collectives count
ARCHS = ["qwen3-0.6b", "qwen2.5-14b", "recurrentgemma-9b",
         "llama-3.2-vision-90b"]
HEADER = ("arch,params,k_updates,bytes_per_chip,t_agg_gpu_ms,"
          "t_agg_gpu_1000p_s,t_agg_cpu_1000p_s,collectives")


def _padded(params: int, ranks: int) -> int:
    """The flattened update padded to shard evenly over ``ranks``."""
    return ranks * ((params + ranks - 1) // ranks)


def _update_sharding(mesh) -> NamedSharding:
    """The (K, P) stack with P over every mesh axis, major axis first."""
    names = tuple(mesh_sizes(mesh))
    return NamedSharding(mesh, (None, names[0] if len(names) == 1 else names))


def fuse_sharded(stack, weights: torch.Tensor, mesh=None):
    """The (P,) weighted sum of a (K, P) update stack whose P is sharded
    over every axis of ``mesh``: each rank fuses its own (K, P / ranks)
    block through ``kernels.fused_agg`` (its plain version for a tensor on
    the CPU), and the result stays sharded the same way.

    ``stack`` is a DTensor on ``mesh`` (laid out so if it is not yet);
    ``weights`` (K,) fp32 are the same on every rank. Returns a DTensor on
    ``mesh``; with no mesh, one process holds the whole stack, a plain
    tensor, and gets a plain tensor."""
    if mesh is None:
        return fused_agg(stack, weights)
    from torch.distributed.tensor import DTensor

    upd = _update_sharding(mesh)
    local = stack.redistribute(mesh, upd.placements()).to_local()
    out = fused_agg(local.contiguous(), weights)
    return DTensor.from_local(
        out, mesh, NamedSharding(mesh, upd.spec[1:]).placements(),
        run_check=False)


def count_collectives(fn):
    """(fn(), the collectives ``CommDebugMode`` counted while it ran)."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        out = fn()
    return out, comm.get_total_counts()


def run_one(arch: str, k: int = 8, device=None) -> Dict:
    """The analytic row of ``arch`` for the 256-rank production layout;
    ``collectives`` counted around ``fuse_sharded`` of a (K, STAND_IN)
    stand-in stack on ``device`` (the card unless named) in this process
    alone."""
    configs.load_all()
    cfg = configs.get_config(arch)
    params = M.n_params(cfg)
    chips = math.prod(PRODUCTION.values())
    flat = _padded(params, chips)
    bytes_per_chip = (k + 1) * flat * 4 / chips  # K reads + 1 write
    t_gpu_ms = bytes_per_chip / H100.hbm_bw * 1e3
    # paper-style CPU aggregation of 1000 updates, one 2-core container
    t_pair_cpu = 3 * params * 4 / CPU_EFF_BW
    t_cpu_1000 = 1000 * t_pair_cpu / 2
    # scale the roofline to the paper's 1000-party round (linear in K)
    t_gpu_1000_s = t_gpu_ms / 1e3 * (1000 + 1) / (k + 1)

    dev = get_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = torch.randn(k, STAND_IN, generator=gen, device=dev)
    w = torch.full((k,), 1.0 / k, device=dev)
    _, n = count_collectives(lambda: fuse_sharded(stack, w))
    return {
        "arch": arch,
        "params": params,
        "k": k,
        "bytes_per_chip": int(bytes_per_chip),
        "t_agg_gpu_ms": round(t_gpu_ms, 3),
        "t_agg_gpu_1000p_s": round(t_gpu_1000_s, 3),
        "t_agg_cpu_1000p_s": round(t_cpu_1000, 1),
        "collectives": n,
    }


def _event_ms(fn, iters: int = 5, runs: int = 3) -> float:
    """Milliseconds a call of ``fn`` on the card: the median over ``runs``
    of the mean of ``iters`` calls between CUDA events, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(runs):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def measure(arch: str, k: int = 8, mesh=None) -> Dict:
    """One rank's fusion on the card: K fp32 updates of ``arch``'s
    flattened parameters, padded to shard evenly over ``mesh`` (the whole
    update on one rank, or with no mesh), through ``fuse_sharded``.

    The fusion runs once and must count no collective; its result is held
    against ``fused_agg_ref`` on the same block: the two sum K terms in
    other orders, so they may differ by K fp32 roundings of
    sum_k |w_k u_kn|. Then the kernel, the plain version and
    ``torch.matmul`` (the library call computing the same sum) are timed
    with CUDA events. The bound is the larger of the bytes (K reads of the
    block, its weights, one write) over 3.35 TB/s and its 2 K N fp32
    operations over 67 TFLOP/s. ``launches`` counts the kernel's launches
    in the one fusion, not in the timing."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure needs a CUDA device; none is available")
    from torch.distributed.tensor import DTensor

    configs.load_all()
    params = M.n_params(configs.get_config(arch))
    ranks = 1 if mesh is None else mesh.size()
    n = _padded(params, ranks) // ranks
    gen = torch.Generator(device="cuda").manual_seed(0)
    block = torch.randn(k, n, generator=gen, device="cuda")
    w = torch.rand(k, generator=gen, device="cuda")
    w = w / w.sum()
    stack = block
    if mesh is not None:
        stack = DTensor.from_local(block, mesh,
                                   _update_sharding(mesh).placements(),
                                   run_check=False)
    before = fused_agg.launches
    out, collectives = count_collectives(lambda: fuse_sharded(stack, w, mesh))
    launches = fused_agg.launches - before
    if collectives:
        raise AssertionError(f"the rank-local fusion counted {collectives} "
                             f"collectives")
    got = out if mesh is None else out.to_local()
    want = fused_agg_ref(block, w)
    err, chunk = 0.0, 1 << 26
    for i in range(0, n, chunk):
        u = block[:, i:i + chunk]
        diff = (got[i:i + chunk] - want[i:i + chunk]).abs()
        scale = torch.einsum("k,kn->n", w, u.abs())
        if not bool((diff <= k * 2.0 ** -23 * scale).all()):
            raise AssertionError(f"fused_agg disagrees with its plain version "
                                 f"at elements {i}-{i + u.shape[1]}")
        err = max(err, float(diff.max()))
    del got, want, out, diff, scale
    torch.cuda.empty_cache()
    ms = _event_ms(lambda: fuse_sharded(stack, w, mesh))
    plain_ms = _event_ms(lambda: fused_agg_ref(block, w))
    library_ms = _event_ms(lambda: torch.matmul(w, block))
    t_bytes = (k * n * 4 + k * 4 + n * 4) / H100.hbm_bw * 1e3
    t_ops = 2 * k * n / H100.peak_flops_fp32 * 1e3
    bound = max(t_bytes, t_ops)
    return {
        "arch": arch, "params": params, "k": k, "ranks": ranks,
        "n_per_rank": n, "ms": ms, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "ratio": ms / bound, "plain_ms": plain_ms, "library_ms": library_ms,
        "max_abs_err": err, "collectives": collectives,
        "launches": launches, "card": torch.cuda.get_device_name(0),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the collective count (default: "
                         "the CUDA card)")
    ap.add_argument("--measure", default=None,
                    help="also measure this architecture's fusion on the "
                         "card (its K fp32 updates must fit)")
    args = ap.parse_args(argv)
    print(HEADER)
    for arch in ARCHS:
        r = run_one(arch, device=args.device)
        if r["collectives"]:
            raise AssertionError(
                f"{arch}: coordinate-wise fusion must run collective-free, "
                f"got {r['collectives']}")
        print(",".join(str(v) for v in r.values()), flush=True)
    if args.measure:
        print(measure(args.measure), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
