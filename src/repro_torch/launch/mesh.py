"""The card's figures for the roofline analysis, the reference's meshes,
and the count of cards a run spans.

``HardwareSpec`` keeps the reference's five fields under their names;
``H100`` is the one card the port runs on. ``n_chips`` counts the cards of
an int or a ``torch.distributed`` ``DeviceMesh``.

``make_production_mesh`` and ``make_host_mesh`` build a ``DeviceMesh`` of
the reference's shapes and axis names (16 x 16 ``("data", "model")``, 2 x
16 x 16 ``("pod", "data", "model")``, and a small ``data x model`` one) in
the current process group: the caller starts the group (gloo for CPU
ranks, NCCL for cards) with as many ranks as the mesh has. Without a group,
or with one of another size, they raise, as ``jax.make_mesh`` does without
the devices. ``one_rank_mesh`` gives a launcher a 1 x 1 mesh, starting a
one-rank group for it when there is none. ``launch.sharding`` resolves specs on a mesh's axis sizes alone,
so the production layouts are checked without any ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch


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


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                 device: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device is None and dist.is_initialized() and \
            dist.get_backend() == "fake":
        from repro_torch.launch.layout import device_type

        device = device_type()  # a layout-only group (launch.layout)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to build "
                "the mesh over CPU ranks")
        device = "cuda"
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks; none is initialised")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks, this one has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 2,
                   device: Optional[str] = None):
    """Small mesh, for tests (gloo CPU ranks) and the one-card launchers."""
    return _device_mesh((data, model), ("data", "model"), device)


@contextlib.contextmanager
def one_rank_mesh(device: torch.device) -> Iterator:
    """A 1 x 1 ``("data", "model")`` mesh on ``device``'s type in the
    current process group. Where there is none, a one-rank group (gloo on
    the CPU, NCCL on the card, rendezvous in an in-process store) is
    started for the mesh and destroyed on exit."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device=device.type)
    finally:
        if started:
            dist.destroy_process_group()
