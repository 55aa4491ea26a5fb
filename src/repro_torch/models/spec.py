"""Single-source-of-truth parameter specs.

Every model defines ``param_specs(cfg) -> dict`` (a nested dict whose leaves
are :class:`TensorSpec`); parameters are initialised from that tree, so the
port's parameters have the reference's keys, shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import Pytree, tree_leaves, tree_map

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape + logical axis names + init for one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | rglru_lambda
    scale: float = 1.0  # stddev multiplier for "normal"
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError((self.shape, self.axes))


def stack_specs(specs: Pytree, n: int, axis_name: str = "layers") -> Pytree:
    """Add a leading stacked-layer dim of size ``n`` to every spec leaf."""
    return tree_map(
        lambda s: dataclasses.replace(
            s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes),
        specs,
    )


def _init_leaf(gen: torch.Generator, s: TensorSpec) -> torch.Tensor:
    dt = DTYPES[s.dtype]
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=gen.device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=gen.device)
    if s.init == "rglru_lambda":
        # Griffin: a in [0.9, 0.999] -> Lambda = softplus^{-1}((-log a)/c), c=8.
        u = torch.rand(s.shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * (0.999 - 0.9) + 0.9
        return torch.log(torch.expm1(-torch.log(u) / 8.0)).to(dt)
    if s.init != "normal":
        raise ValueError(f"unknown init {s.init!r}")
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    std = s.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dt)


def init_params(gen: torch.Generator, specs: Pytree) -> Pytree:
    """Materialise random parameters for a spec tree on the generator's
    device, drawing the leaves in tree order from one generator."""
    return tree_map(lambda s: _init_leaf(gen, s), specs)


def abstract_params(specs: Pytree) -> Pytree:
    """Tensors on the "meta" device for a spec tree: shapes and dtypes, no
    storage (the reference's ShapeDtypeStructs)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                          device="meta"), specs)


def count_params(specs: Pytree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))
