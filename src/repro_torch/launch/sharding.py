"""Logical-axis -> mesh-axis sharding rules with divisibility-aware fallback.

Every parameter/cache tensor carries logical axis names (see models/spec.py).
``resolve_spec`` greedily assigns mesh axes per tensor: a dim is sharded over
the first candidate whose size divides the dim and whose mesh axes are not
already used by another dim of the same tensor; otherwise the next
candidate (e.g. heads -> model, falling back to head_dim -> model for
20-head archs on a 16-way model axis) or replication.

A mesh is a ``torch.distributed`` ``DeviceMesh`` or a mapping of axis names
to sizes: a layout with no ranks behind it (the reference's
``AbstractMesh``), which is all ``resolve_spec`` needs. A spec is a plain
tuple in ``PartitionSpec``'s normal form, one entry per tensor dim: None, an
axis name, or a tuple of two or more names, the major axis first.
``NamedSharding.placements`` turns it into DTensor placements, one per mesh
dim, and ``local_shard`` gives the block a rank holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import Pytree, tree_map
from repro_torch.models.sharding_ctx import (entry_axes, mesh_sizes,
                                             spec_placements)

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# candidate mesh-axis tuples per logical axis, in preference order.
# "+pod" entries are expanded to include the pod axis when it exists.
PARAM_RULES: Dict[str, List[Tuple[str, ...]]] = {
    "d_ff": [("model",)],
    "heads": [("model",)],
    "head_dim": [("model",)],
    "kv_heads": [],  # GQA: replicate K/V heads (Megatron-style duplication)
    "vocab": [("model",)],
    "d_model": [("data",)],  # FSDP: shard the "other" dim over data
    "d_inner": [("model",)],
    "experts": [("model",)],
    "layers": [],
}

# decode profile (§Perf hillclimb H2): serving holds no optimizer state, so
# FSDP-style d_model-over-data sharding only buys an all-gather of every
# parameter on every decode step. Pure tensor-parallel params instead.
DECODE_PARAM_RULES: Dict[str, List[Tuple[str, ...]]] = dict(
    PARAM_RULES, d_model=[]
)

ACT_RULES: Dict[str, List[Tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "seq": [],  # set to [("model",)] by sequence-parallel configs
    "cache_seq": [],
    "kv_heads": [],
    "heads": [("model",)],
    "d_inner": [("model",)],
    "d_model": [],
    "vocab": [("model",)],
}


# logical axes claim mesh axes in this order (e.g. kv_heads gets the model
# axis before cache_seq falls back to it)
PRIORITY = (
    "heads", "d_ff", "experts", "d_inner", "kv_heads", "vocab", "head_dim",
    "d_model", "batch", "cache_seq", "seq", "layers",
)

Mesh = Any  # a DeviceMesh or a Mapping[str, int] of axis sizes


def _normal(axes: Optional[Sequence[str]]):
    """One spec entry in PartitionSpec's normal form."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def resolve_spec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh: Mesh,
    rules: Dict[str, List[Tuple[str, ...]]],
) -> Spec:
    sizes = mesh_sizes(mesh)
    used: set = set()
    out: List[Optional[Tuple[str, ...]]] = [None] * len(shape)
    order = sorted(
        range(len(shape)),
        key=lambda i: PRIORITY.index(axes[i]) if axes[i] in PRIORITY else 99,
    )
    for i in order:
        dim, name = shape[i], axes[i]
        if name is None or name not in rules:
            continue
        for cand in rules[name]:
            cand_t = tuple(a for a in cand if a in sizes)
            if not cand_t:
                continue
            size = math.prod(sizes[a] for a in cand_t)
            if size <= 1 or any(a in used for a in cand_t):
                continue
            if dim % size == 0:
                out[i] = cand_t
                used.update(cand_t)
                break
    return tuple(_normal(t) for t in out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: how a tensor of the spec's rank is laid out."""

    mesh: Mesh
    spec: Spec

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim (``spec_placements``)."""
        return spec_placements(self.mesh, self.spec)


def local_shard(tensor: torch.Tensor, sharding: NamedSharding,
                coords: Sequence[int]) -> torch.Tensor:
    """The block of ``tensor`` (the whole value) that the rank at mesh
    coordinates ``coords`` holds under ``sharding``: a view, so gradients
    flow back into the whole tensor."""
    sizes = mesh_sizes(sharding.mesh)
    at = dict(zip(sizes, coords))
    out = tensor
    for i, entry in enumerate(sharding.spec):
        names = entry_axes(entry)
        if not names:
            continue
        n = math.prod(sizes[a] for a in names)
        if tensor.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(tensor.shape)} does not "
                             f"divide over {names} ({n})")
        block = 0
        for a in names:  # major axis first
            block = block * sizes[a] + at[a]
        size = tensor.shape[i] // n
        out = out.narrow(i, block * size, size)
    return out


def tree_shardings(
    specs_tree: Pytree,  # leaves: TensorSpec
    mesh: Mesh,
    rules: Dict[str, List[Tuple[str, ...]]] = PARAM_RULES,
) -> Pytree:
    return tree_map(
        lambda s: NamedSharding(mesh, resolve_spec(s.shape, s.axes, mesh,
                                                   rules)),
        specs_tree,
    )


def like_tree(shardings: Pytree, template: Pytree) -> Pytree:
    """Broadcast param shardings onto a same-structure tree (e.g. adam m/v)."""
    return tree_map(lambda s, _: s, shardings, template)


def batch_sharding(mesh: Mesh, shape: Sequence[int], batch_dim: int = 0
                   ) -> NamedSharding:
    spec = resolve_spec(
        shape,
        ["batch" if i == batch_dim else None for i in range(len(shape))],
        mesh,
        ACT_RULES,
    )
    return NamedSharding(mesh, spec)


def activation_rules(mesh: Mesh, sequence_parallel: bool
                     ) -> Dict[str, Optional[Tuple[str, ...]]]:
    """Rules consumed by models.sharding_ctx.constrain for the residual stream."""
    names = set(mesh_sizes(mesh))
    batch = tuple(a for a in ("pod", "data") if a in names) or None
    return {
        "batch": batch,
        "seq": ("model",) if sequence_parallel and "model" in names else None,
        "d_model": None,
        # vocab-parallel logits (§Perf H4): keep the LM-head output sharded
        # over the model axis so no rank gathers the full head weight or
        # materialises (B,S,V) logits; the CE logsumexp reduces the sharded
        # vocab axis with one small (B,S) sum.
        "vocab": ("model",) if "model" in names else None,
    }
