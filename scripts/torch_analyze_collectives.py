"""The port's twin of ``scripts/analyze_collectives.py``: run one (arch,
shape, profile) step on the reference's 16 x 16 production layout, dry,
and print its collectives grouped by call site and output shape, largest
first.

  PYTHONPATH=src python scripts/torch_analyze_collectives.py llama-3.2-vision-90b train_4k [optimized]

The step runs on "meta" DTensors over a 256-rank layout-only process
group in this process (``repro_torch.launch.layout``), with autograd's
anomaly mode on, so that a collective of the backward names the forward
line it belongs to. Columns as the reference's: bytes (a rank's output
bytes, at each tensor's own dtype), kind, shape, cnt (collectives a
firing), trip (the times the site fired: the layers are a Python loop)
and the site in ``repro_torch`` (``(bwd)`` for the backward's).
"""
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arch, shape = argv[0], argv[1]
    profile = argv[2] if len(argv) > 2 else "baseline"

    from repro_torch import configs
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import layout
    from repro_torch.launch.dryrun import collectives_by_site
    from repro_torch.launch.mesh import make_production_mesh

    configs.load_all()
    cfg = configs.get_config(arch)
    with layout.layout_group(256):
        mesh = make_production_mesh(multi_pod=False)
        fn, dargs = layout.build_on_mesh(cfg, INPUT_SHAPES[shape], mesh,
                                         profile)
        _, record = layout.run_step(fn, dargs, mesh, cfg, profile,
                                    backward_sites=True)
    rows = collectives_by_site(record)
    print(f"total collective bytes/device: {record.total_bytes():.3e}")
    print(f"{'bytes':>12} {'kind':>18} {'shape':>28} {'cnt':>4} {'trip':>5}"
          f"  site")
    for nb, kind, shp, cnt, trip, site in rows:
        print(f"{nb:12.3e} {kind:>18} {shp:>28} {cnt:4d} {trip:5d}  "
              f"{site[:60]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
