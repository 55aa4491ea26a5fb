"""The card's figures for the roofline analysis, and the count of cards a
run spans.

``HardwareSpec`` keeps the reference's five fields under their names;
``H100`` is the one card the port runs on. ``n_chips`` counts the cards of
an int or a ``torch.distributed`` ``DeviceMesh``.

The reference's ``make_production_mesh`` and ``make_host_mesh`` (a 16 x 16
or 2 x 16 x 16 mesh of named axes, and a small one over forced host
devices) are not here yet: they wait for the slice that runs the port on
more than one card. On one card every sharding rule resolves to
"replicated" and every collective spans one rank, so a mesh would change no
number this module's users compute, and nothing could hold it against a
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card constants of the roofline analysis.

    ``peak_flops_fp32`` is the port's one field beyond the reference's: the
    fp32 rate outside the tensor cores, which only the fusion kernels'
    bound reads (their fp32 multiply-adds never reach the tensor cores).
    The roofline itself reads the five fields the reference has."""

    peak_flops_bf16: float  # FLOP/s, dense
    hbm_bw: float  # B/s
    ici_link_bw: float  # B/s per link, each way
    hbm_bytes: float  # capacity
    # cross-node bandwidth per card, used for the multi-node collective term
    dcn_bw: float  # B/s
    peak_flops_fp32: Optional[float] = None  # FLOP/s, outside tensor cores


H100 = HardwareSpec(
    # H100 SXM data sheet: 989 TFLOP/s bf16 dense (1,979 with sparsity)
    peak_flops_bf16=989e12,
    # H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s
    hbm_bw=3.35e12,
    # H100 SXM data sheet: NVLink 900 GB/s over 18 NVLink-4 links, both
    # ways together: 25 GB/s a link each way
    ici_link_bw=25e9,
    hbm_bytes=80e9,
    # DGX H100 data sheet: one 400 Gb/s ConnectX-7 port per card
    dcn_bw=50e9,
    # H100 SXM data sheet: 67 TFLOP/s fp32
    peak_flops_fp32=67e12,
)


def n_chips(mesh) -> int:
    """The cards of ``mesh``: an int, or a ``DeviceMesh`` (all its
    dimensions)."""
    if isinstance(mesh, int):
        return mesh
    return int(mesh.size())
