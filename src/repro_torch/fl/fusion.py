"""Model-update fusion algorithms (the aggregation ⊕ of §2.1).

All are coordinate-wise over the flattened update vectors and LINEAR in the
updates — the property JIT aggregation exploits: partial aggregates can be
checkpointed and resumed, and updates can be fused incrementally in any
order with the same result.

  FedAvg  — dataset-size-weighted mean of party weights.
  FedSGD  — mean of party gradients, applied by the server optimizer.
  FedProx — server-side fusion identical to FedAvg (the proximal term
            mu/2*||w - w_global||^2 modifies the PARTY loss; see party.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from repro_torch import Pytree, tree_map
from repro_torch.kernels import accumulate, accumulate_batch, fuse_updates


@dataclasses.dataclass
class FusionState:
    """Checkpointable partial aggregate: fp32 accumulator + total weight."""

    acc: Optional[Pytree] = None
    total_weight: float = 0.0
    n_fused: int = 0

    def fold(self, update: Pytree, weight: float) -> "FusionState":
        return FusionState(
            acc=accumulate(self.acc, update, weight),
            total_weight=self.total_weight + weight,
            n_fused=self.n_fused + 1,
        )

    def fold_batch(self, updates: Sequence[Pytree], weights: Sequence[float],
                   *, in_place: bool = False) -> "FusionState":
        """``fold`` of each update in turn, in one ``batch_fold`` launch
        (at most ``batch_fold.C_MAX`` updates): the same bits, the weights
        summed in the same order. ``in_place`` updates this state's
        accumulator itself; otherwise a new one is made, as ``fold`` does,
        since a checkpointed partial holds the old one by reference."""
        tw = self.total_weight
        for w in weights:
            tw += w
        return FusionState(
            acc=accumulate_batch(self.acc, updates, weights,
                                 in_place=in_place),
            total_weight=tw,
            n_fused=self.n_fused + len(updates),
        )

    def merge(self, other: "FusionState") -> "FusionState":
        """Merge two partial aggregates (parallel aggregation)."""
        if self.acc is None:
            return other
        if other.acc is None:
            return self
        return FusionState(
            acc=accumulate(self.acc, other.acc, 1.0),
            total_weight=self.total_weight + other.total_weight,
            n_fused=self.n_fused + other.n_fused,
        )

    def result(self, dtype: Optional[torch.dtype] = None) -> Pytree:
        if self.acc is None or self.total_weight <= 0:
            raise ValueError("no updates fused yet")
        tw = self.total_weight
        return tree_map(lambda a: (a / tw).to(dtype or a.dtype), self.acc)


class FusionAlgorithm:
    name = "base"
    server_side = "weights"  # what parties send: weights | gradients

    def weight_of(self, n_examples: int) -> float:
        return float(max(n_examples, 1))

    def fuse(self, updates: Sequence[Pytree], n_examples: Sequence[int]
             ) -> Pytree:
        ws = [self.weight_of(n) for n in n_examples]
        total = sum(ws)
        return fuse_updates(updates, [w / total for w in ws])

    def apply(self, global_model: Pytree, fused: Pytree, lr: float = 1.0
              ) -> Pytree:
        """Turn the fused quantity into the new global model."""
        return tree_map(lambda g, f: f.to(g.dtype), global_model, fused)


class FedAvg(FusionAlgorithm):
    name = "fedavg"


class FedProx(FusionAlgorithm):
    """Server side == FedAvg; the proximal term lives in the party loss."""

    name = "fedprox"


class FedSGD(FusionAlgorithm):
    """Parties send gradients; the server applies one SGD step."""

    name = "fedsgd"
    server_side = "gradients"

    def apply(self, global_model: Pytree, fused_grad: Pytree, lr: float = 1.0
              ) -> Pytree:
        return tree_map(
            lambda w, g: (w.to(torch.float32) - lr * g.to(torch.float32)
                          ).to(w.dtype),
            global_model,
            fused_grad,
        )


ALGORITHMS: Dict[str, FusionAlgorithm] = {
    a.name: a() for a in (FedAvg, FedProx, FedSGD)
}


def get_algorithm(name: str) -> FusionAlgorithm:
    return ALGORITHMS[name]
