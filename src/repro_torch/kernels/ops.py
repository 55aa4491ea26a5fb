"""Public wrappers over the fusion kernels, operating on model-update trees
(the paper's "list of one-dimensional vectors, one per layer"): leaves are
flattened, fused leaf-wise by the kernels, and reshaped back.

The device of the tensors decides the route: on the card the CUDA kernels,
on the CPU their plain versions (the reference's ``interpret`` flag)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import Pytree, tree_map
from repro_torch.kernels.fused_agg import fused_agg
from repro_torch.kernels.pair_fuse import pair_fuse


def fuse_updates(
    updates: Sequence[Pytree],
    weights: Optional[Sequence[float]] = None,
) -> Pytree:
    """Weighted fusion of K model updates (FedAvg-style weighted mean when
    weights sum to 1). Leaf-wise: stacks each leaf across updates and runs
    the fused_agg kernel once per leaf."""
    k = len(updates)
    if k < 1:
        raise ValueError("fuse_updates needs at least one update")
    if weights is None:
        weights = [1.0 / k] * k

    def fuse_leaf(*leaves: torch.Tensor) -> torch.Tensor:
        stack = torch.stack([l.reshape(-1) for l in leaves])  # (K, N)
        w = torch.tensor(list(weights), dtype=torch.float32,
                         device=stack.device)
        out = fused_agg(stack, w)
        return out.reshape(leaves[0].shape).to(leaves[0].dtype)

    return tree_map(fuse_leaf, *updates)


def accumulate(acc: Optional[Pytree], update: Pytree, weight: float
               ) -> Pytree:
    """Streaming (incremental) fusion: acc + weight*update, OUT OF PLACE.

    This is the aggregator's inner operation: each arriving update is folded
    into the running fp32 accumulator with the pair_fuse kernel, so
    aggregation state is one model-sized buffer regardless of K. A new
    accumulator is returned because a checkpointed partial aggregate holds
    the old one by reference. The kernel reads a bf16 update directly; the
    sum is the one the fp32 copy of the update would give."""
    if acc is None:
        return tree_map(lambda u: u.to(torch.float32) * weight, update)
    return tree_map(
        lambda a, u: pair_fuse(
            a.reshape(-1), u.reshape(-1), op="wsum", wa=1.0, wb=float(weight),
        ).reshape(a.shape),
        acc,
        update,
    )
