"""PyTorch/CUDA port of the just-in-time aggregation system.

The package mirrors ``src/repro`` module by module. It runs on one NVIDIA
GPU: every entry point takes a ``device`` argument, and with none it uses
the card (and raises when there is none). The CPU is used only when a
caller passes ``device="cpu"``, which is how the parity tests run.

Parameters and model updates are nested dicts (and lists) of tensors with
the reference's keys and shapes; ``tree_map``/``tree_leaves`` walk them in
the reference's leaf order (dict keys sorted).
"""
from __future__ import annotations

from typing import Any, Callable, List, Union

import torch

Pytree = Any


def get_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device the port runs on: the CUDA card unless the caller names
    another device. Raises when no device is named and there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda")


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` leaf-wise over trees of the same structure (nested dicts,
    lists and tuples; anything else is a leaf). ``None`` subtrees stay."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> List[Any]:
    """The leaves of ``tree`` in ``tree_map`` order (dict keys sorted, as
    ``jax.tree.leaves`` orders them)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Pytree, leaves: List[Any]) -> Pytree:
    """A tree shaped like ``like`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
