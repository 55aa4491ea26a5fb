"""Parameters across the package boundary: nested dicts of numpy arrays (what
the reference hands over, e.g. ``jax.tree.map(np.asarray, params)``) to the
port's tensors on a device, and back, with the same keys, shapes and dtypes.

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
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
            bits = torch.from_numpy(a.view(np.int16).copy())
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return tree_map(conv, tree)


def to_numpy(tree: Pytree) -> Pytree:
    """tensor tree -> numpy tree on the host; bf16 leaves come back as
    ``uint16`` bit views (``.view(jnp.bfloat16)`` restores them)."""

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return tree_map(conv, tree)
