"""Optimizers over parameter trees, as (init, update) pairs. The update
returns new parameters (fp32 math, cast back to each parameter's dtype);
moments are fp32 whatever the parameters' dtype, and the state's ``step``
is a 0-d int32 tensor on the parameters' device, as in the reference."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import Pytree, tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair. update returns (new_params, new_state)."""

    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], Tuple[Pytree, Pytree]]
    name: str = "optimizer"


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the fp32 squares summed leaf by leaf, in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Pytree, max_norm: float) -> Pytree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads)


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def _step0(params: Pytree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros32(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """SGD, out of place: p <- p - lr_t * u, where u is the gradient, or
    with ``momentum`` the fp32 buffer momentum * m + g."""
    lr_fn = _as_schedule(lr)

    def init(params):
        return {"step": _step0(params),
                "mom": _zeros32(params) if momentum else None}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                           state["mom"], grads)
            upd = mom
        else:
            mom = None
            upd = grads
        new_params = tree_map(
            lambda p, u: (p.to(torch.float32) - lr_t * u.to(torch.float32)
                          ).to(p.dtype),
            params,
            upd,
        )
        return new_params, {"step": step, "mom": mom}

    return Optimizer(init, update, "sgd")


def _adam_core(lr, b1, b2, eps, weight_decay):
    lr_fn = _as_schedule(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros32(params),
                "v": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        # the bias corrections in fp32 tensors, as the reference's
        s32 = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, s32)
        bc2 = 1.0 - torch.pow(b2, s32)

        def upd_m(m, g):
            return b1 * m + (1 - b1) * g.to(torch.float32)

        def upd_v(v, g):
            return b2 * v + (1 - b2) * torch.square(g.to(torch.float32))

        m_new = tree_map(upd_m, state["m"], grads)
        v_new = tree_map(upd_v, state["v"], grads)

        def upd_param(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            p32 = p.to(torch.float32)
            if weight_decay:
                delta = delta + weight_decay * p32
            return (p32 - lr_t * delta).to(p.dtype)

        new_params = tree_map(upd_param, params, m_new, v_new)
        return new_params, {"step": step, "m": m_new, "v": v_new}

    return init, update


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    init, update = _adam_core(lr, b1, b2, eps, 0.0)
    return Optimizer(init, update, "adam")


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    init, update = _adam_core(lr, b1, b2, eps, weight_decay)
    return Optimizer(init, update, "adamw")
