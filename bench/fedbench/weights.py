"""Weights and update pools made on the device from the seed.

A configuration's file lists its leaves (``leaves``: the path of keys,
the shape and the initialiser). Every normal leaf of one tree is drawn in
one ``torch.randn`` call into a flat buffer in the model's dtype on a
generator on the device, and scaled in place leaf by leaf; each leaf is a
contiguous view of that buffer. Initialisers:

* ``normal`` with ``std``: N(0, std^2);
* ``ones``, ``zeros``;
* ``dt_bias``: Mamba-2's, dt log-uniform in [1e-3, 1e-1], the bias its
  inverse softplus.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def nest(leaves: List[Dict], tensors: List[torch.Tensor]) -> Dict:
    """The nested dict of ``tensors`` at the leaves' key paths."""
    tree: Dict = {}
    for leaf, t in zip(leaves, tensors):
        node = tree
        for key in leaf["path"][:-1]:
            node = node.setdefault(key, {})
        node[leaf["path"][-1]] = t
    return tree


def flatten(tree: Dict, leaves: List[Dict]) -> List[torch.Tensor]:
    """The tensors of ``tree`` at the leaves' key paths, in their order."""
    out = []
    for leaf in leaves:
        node = tree
        for key in leaf["path"]:
            node = node[key]
        out.append(node)
    return out


def _normal_views(leaves, gen, dtype, device, std_of) -> List[torch.Tensor]:
    n = sum(math.prod(leaf["shape"]) for leaf in leaves)
    flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
    out, at = [], 0
    for leaf in leaves:
        size = math.prod(leaf["shape"])
        view = flat[at:at + size].view(leaf["shape"])
        view.mul_(std_of(leaf))
        out.append(view)
        at += size
    return out


def make_model(config: Dict, gen: torch.Generator,
               device: torch.device) -> Dict:
    """The global model of ``config`` drawn from ``gen``, in its dtype."""
    leaves = config["leaves"]
    dtype = DTYPES[config["run"]["dtype"]]
    normal = [leaf for leaf in leaves if leaf["init"] == "normal"]
    drawn = dict(zip((id(x) for x in normal), _normal_views(
        normal, gen, dtype, device, lambda leaf: leaf["std"])))
    tensors = []
    for leaf in leaves:
        if leaf["init"] == "normal":
            tensors.append(drawn[id(leaf)])
        elif leaf["init"] == "ones":
            tensors.append(torch.ones(leaf["shape"], dtype=dtype,
                                      device=device))
        elif leaf["init"] == "zeros":
            tensors.append(torch.zeros(leaf["shape"], dtype=dtype,
                                       device=device))
        elif leaf["init"] == "dt_bias":
            u = torch.rand(leaf["shape"], generator=gen, dtype=torch.float32,
                           device=device)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                           + math.log(1e-3))
            tensors.append((dt + torch.log(-torch.expm1(-dt))).to(dtype))
        else:
            raise ValueError(f"unknown initialiser {leaf['init']!r}")
    return nest(leaves, tensors)


def make_pool(config: Dict, n: int, gen: torch.Generator,
              device: torch.device) -> List[List[torch.Tensor]]:
    """``n`` distinct update trees as lists of leaves (the file's order):
    each leaf N(0, std^2) with its normal leaf's std, N(0, 1) for the
    others; one draw a tree."""
    dtype = DTYPES[config["run"]["dtype"]]
    return [_normal_views(config["leaves"], gen, dtype, device,
                          lambda leaf: leaf.get("std", 1.0))
            for _ in range(n)]
