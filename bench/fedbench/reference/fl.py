"""Plain references of the aggregator's fold.

``weighted_mean`` is the fused model of a backlog: the examples-weighted
mean of the updates in float64. ``sequential_fold`` is the same sum taken
update by update in a given accumulator dtype (the aggregator's control).
"""
from __future__ import annotations

from typing import Sequence

import torch

F32, F64 = torch.float32, torch.float64


@torch.no_grad()
def weighted_mean(pool_leaf: Sequence[torch.Tensor], picks: Sequence[int],
                  n_examples: Sequence[int]) -> torch.Tensor:
    """sum_i n_i u_{picks_i} / sum_i n_i in float64, one leaf: the weights
    of each distinct update summed first."""
    per = {}
    for j, n in zip(picks, n_examples):
        per[j] = per.get(j, 0.0) + float(max(n, 1))
    acc = torch.zeros(pool_leaf[0].shape, dtype=F64,
                      device=pool_leaf[0].device)
    for j, w in per.items():
        acc.add_(pool_leaf[j].to(F64), alpha=w)
    return acc / sum(per.values())


@torch.no_grad()
def sequential_fold(pool_leaf: Sequence[torch.Tensor], picks: Sequence[int],
                    n_examples: Sequence[int], dtype: torch.dtype
                    ) -> torch.Tensor:
    """The weighted mean folded update by update with an accumulator in
    ``dtype``: acc <- acc + n_i u_i, rounded to ``dtype`` each time."""
    acc = None
    total = 0.0
    for j, n in zip(picks, n_examples):
        w = float(max(n, 1))
        term = (pool_leaf[j].to(F32) * w).to(dtype)
        acc = term if acc is None else (acc.to(F32) + term.to(F32)).to(dtype)
        total += w
    return acc.to(F32) / total
