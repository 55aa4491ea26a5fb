"""Parameters across the package boundary: nested dicts of numpy arrays (what
the reference hands over, e.g. ``jax.tree.map(np.asarray, params)``) to the
port's tensors on a device, and back, with the same keys, shapes and dtypes.

Any tree crosses, not only parameters: optimizer state and KV caches carry
int32 leaves (cache positions, a 0-d ``step`` or ``t``), which keep their
dtype and shape, and ``None`` subtrees (SGD without momentum) stay.

numpy has no bfloat16 of its own, so bf16 leaves cross as ``uint16`` bit
views, the way the reference's checkpoints store them. An incoming array
whose dtype is named ``bfloat16`` (ml_dtypes, as JAX gives it) is read
through the same view, so the port needs no ml_dtypes.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import Pytree, get_device, tree_map


def to_torch(tree: Pytree, device: Union[str, torch.device, None] = None
             ) -> Pytree:
    """numpy tree -> tensor tree on ``device``; bf16 and uint16 leaves
    become bfloat16 tensors bit for bit."""
    dev = get_device(device)

    def conv(a) -> torch.Tensor:
        a = np.asarray(a)  # not ascontiguousarray, which makes 0-d arrays 1-d
        if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
            return bf16_from_bits(a).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return tree_map(conv, tree)


def to_numpy(tree: Pytree) -> Pytree:
    """tensor tree -> numpy tree on the host; bf16 leaves come back as
    ``uint16`` bit views (``.view(jnp.bfloat16)`` restores them)."""
    return tree_map(leaf_to_numpy, tree)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor on the host as numpy; a bf16 tensor as its ``uint16`` bit
    view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    """A CPU bf16 tensor holding the bits of a ``uint16`` (or ml_dtypes
    bfloat16) array."""
    bits = torch.from_numpy(np.asarray(a).view(np.int16).copy())
    return bits.view(torch.bfloat16)
