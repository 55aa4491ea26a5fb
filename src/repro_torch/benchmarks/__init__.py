"""The port's benchmarks: one section per table or figure of the paper,
the counterparts of the JAX package's ``benchmarks/``.

The simulation benchmarks (``latency``, ``resources``, ``jit_ablation``,
``prediction_accuracy``, ``drift``, ``multijob``, ``hierarchical``,
``fleet``, ``simcore``, ``online``) and ``workloads`` are copies that run on
the port's simulation vehicles; they touch no device and print the same
rows. ``real_ablation`` (one real federated run, then its arrivals replayed
under every strategy), ``periodicity`` (Figs. 3-4 from real training steps)
and ``kernel_bench`` (the CUDA fusion kernels' launch shapes) run on the
card unless given ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only SECTION]
"""
