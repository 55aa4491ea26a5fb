"""Optimizers over parameter trees, as (init, update) pairs. The update
returns new parameters (fp32 math, cast back to each parameter's dtype)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import Pytree, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair. update returns (new_params, new_state)."""

    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], Tuple[Pytree, Pytree]]
    name: str = "optimizer"


def sgd(lr: float) -> Optimizer:
    """Plain SGD: p <- p - lr * g, out of place."""

    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        new_params = tree_map(
            lambda p, g: (p.to(torch.float32) - lr * g.to(torch.float32)
                          ).to(p.dtype),
            params,
            grads,
        )
        return new_params, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")
