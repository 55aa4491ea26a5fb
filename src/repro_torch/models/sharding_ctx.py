"""Activation-sharding context: lets launch-layer code install logical->mesh
rules that model code applies to the residual stream, without models
importing the launch layer. No-op when no rules are installed.

``constrain`` hints a layout where the reference's GSPMD constraint does:
a ``DTensor`` is redistributed to the placements the rules give, and a
plain tensor, which has no layout to hint, comes back unchanged (a GSPMD
constraint never changes values either). The port's models call it at the
reference's places, so with plain tensors every call is an identity.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Optional, Tuple


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order, of a ``DeviceMesh`` or
    of a mapping of axis names to sizes (a layout with no ranks)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: None, an axis name or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh, spec) -> tuple:
    """DTensor placements of a spec (one entry per tensor dim: None, an
    axis name or a tuple of names), one per mesh dim: ``Shard(i)`` where
    tensor dim i names that mesh axis, else ``Replicate()``. A dim over two
    axes shards on both mesh dims, which DTensor splits in mesh order, the
    first mesh dim the major one; JAX splits in the spec's order, so the
    spec must name them in mesh order (the rules' ``("pod", "data")`` and
    ``("data", "model")`` do), else this raises."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_sizes(mesh))
    owner = {}
    for i, entry in enumerate(spec):
        names = entry_axes(entry)
        if [order.index(a) for a in names] != sorted(order.index(a)
                                                     for a in names):
            raise ValueError(f"DTensor splits a dim over mesh dims in mesh "
                             f"order {order}; {names} is not")
        owner.update((a, i) for a in names)
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in order)


_RULES: Optional[Dict[str, Optional[Tuple[str, ...]]]] = None
_MESH = None
_PROFILE = "baseline"


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Optional[Tuple[str, ...]]],
                        profile: str = "baseline"):
    global _RULES, _MESH, _PROFILE
    prev, _RULES = _RULES, rules
    prev_mesh, _MESH = _MESH, mesh
    prev_prof, _PROFILE = _PROFILE, profile
    try:
        yield
    finally:
        _RULES = prev
        _MESH = prev_mesh
        _PROFILE = prev_prof


def is_optimized() -> bool:
    return _PROFILE == "optimized" and _MESH is not None


# features measured NET-NEGATIVE and excluded from the default optimized
# profile (kept selectable for the §Perf ablations): kv_anchor removes the
# per-chunk attention all-reduces (-5.2e11 B) but seq-replicates K/V through
# the remat stack (+3.8e11 B all-gather, 7.5x temp memory on the 90B VLM).
DEFAULT_OFF = {"kv_anchor"}


def opt_feature(name: str) -> bool:
    """True when the optimized profile is active and the named feature is
    enabled. REPRO_DISABLE_OPT / REPRO_ENABLE_OPT (comma-separated) override
    per feature — used for §Perf one-feature-at-a-time ablations. Features:
    moe_shard_map, kv_anchor, vocab_parallel, decode_tp_params."""
    if not is_optimized():
        return False
    off = {s.strip() for s in os.environ.get("REPRO_DISABLE_OPT", "").split(",") if s.strip()}
    on = {s.strip() for s in os.environ.get("REPRO_ENABLE_OPT", "").split(",") if s.strip()}
    if name in off:
        return False
    if name in DEFAULT_OFF and name not in on:
        return False
    return True


def moe_shard_map_ctx():
    """(mesh, batch_axes, model_axis) when the expert-parallel MoE dispatch
    is enabled (optimized profile), else None."""
    if not opt_feature("moe_shard_map"):
        return None
    names = set(mesh_sizes(_MESH))
    if "model" not in names:
        return None
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return _MESH, batch_axes, "model"


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    if _RULES is None or _MESH is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    # only constrain dims whose size divides the assigned axes
    sizes = mesh_sizes(_MESH)
    parts = []
    for dim, name in zip(x.shape, logical_axes):
        axes = _RULES.get(name) if name else None
        if axes:
            total = 1
            for a in axes:
                total *= sizes.get(a, 1)
            parts.append(axes if dim % total == 0 else None)
        else:
            parts.append(None)
    return x.redistribute(_MESH, spec_placements(_MESH, parts))
