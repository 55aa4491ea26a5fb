"""Benchmark driver: one section per paper table/figure, in the JAX
package's order (``benchmarks/run.py``).

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--full]
      [--only kernels|periodicity|prediction|drift|latency|resources|
              jit_ablation|multijob|fleet|online|hierarchical|dist_agg]
      [--device cpu]

--full adds the 10000-party rows (slower). The kernels and periodicity
sections run on the card unless --device names another device: with
``--device cpu`` the kernel section prints its model rows only and
periodicity trains on the CPU. The dist_agg section prints the analytic
rows of the reference's 16 x 16 layout, counting the collectives of the
rank-local fusion on the same device. The other sections are simulations
on a virtual clock and touch no device.
"""
from __future__ import annotations

import sys
import time


def _section(title):
    print(f"\n===== {title} =====", flush=True)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    only = None
    if "--only" in args:
        only = args[args.index("--only") + 1]
    device = None
    if "--device" in args:
        device = args[args.index("--device") + 1]
    full = "--full" in args
    t0 = time.time()

    if only in (None, "kernels"):
        _section("kernel microbenchmarks (closed-form and searched launch "
                 "shapes vs the default)")
        from repro_torch.benchmarks import kernel_bench

        # run(), not main(): main()'s argparse would reject our own flags
        kernel_bench.run(device)

    if only in (None, "periodicity"):
        _section("Fig 3/4: periodicity + linearity (real PyTorch training)")
        from repro_torch.benchmarks import periodicity

        periodicity.main([] if device is None else ["--device", device])

    if only in (None, "prediction"):
        _section("prediction accuracy (central thesis)")
        from repro_torch.benchmarks import prediction_accuracy

        prediction_accuracy.main()

    if only in (None, "drift"):
        _section("§4.2 drift: epoch-time prediction under dataset growth")
        from repro_torch.benchmarks import drift

        drift.main()

    if only in (None, "latency"):
        _section("Fig 7/8: aggregation latency vs parties")
        from repro_torch.benchmarks import latency

        latency.main()

    if only in (None, "resources"):
        _section("Fig 9: container-seconds / cost / savings")
        from repro_torch.benchmarks import resources

        resources.main()

    if only in (None, "jit_ablation"):
        _section("JIT policy ablation (paper timer vs backlog-fill)")
        from repro_torch.benchmarks import jit_ablation

        jit_ablation.main()

    if only in (None, "multijob"):
        _section("multi-job §5.5: deadline priorities vs FIFO under contention")
        from repro_torch.benchmarks import multijob

        multijob.main()

    if only in (None, "fleet"):
        _section("fleet: trace-driven multi-job savings (Fig. 9 headline)")
        from repro_torch.benchmarks import fleet

        print(fleet.HEADER)
        fleet.run(full=full)

    if only in (None, "online"):
        _section("online control plane: burst traffic, autoscaling, SLA")
        from repro_torch.benchmarks import online

        print(online.HEADER)
        online.run(full=full)

    if only in (None, "hierarchical"):
        _section("hierarchical edge->cloud JIT aggregation (beyond-paper)")
        from repro_torch.benchmarks import hierarchical

        hierarchical.main()

    if only in (None, "dist_agg"):
        _section("distributed aggregation on the 16x16 layout (t_agg "
                 "roofline on the H100)")
        from repro_torch.benchmarks import dist_agg

        dist_agg.main([] if device is None else ["--device", device])

    print(f"\n[benchmarks done in {time.time() - t0:.0f}s]")


if __name__ == "__main__":
    main()
