"""Non-IID federated partitioning (paper §6.3: realistic non-IID splits;
homogeneous = equal sizes, heterogeneous = random sizes)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def dirichlet_domain_mixes(
    n_parties: int, n_domains: int, alpha: float = 0.3, seed: int = 0
) -> np.ndarray:
    """Per-party domain mixture via Dirichlet(alpha) — small alpha = more
    skewed (non-IID) label/domain distributions. Returns (P, D)."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(n_domains, alpha), size=n_parties)


def party_sizes(
    n_parties: int,
    total_sequences: int,
    heterogeneous: bool = False,
    seed: int = 0,
    min_frac: float = 0.25,
) -> List[int]:
    """Equal slice per party (homogeneous) or log-uniform random sizes
    (heterogeneous), always summing to total_sequences."""
    if not heterogeneous:
        base = total_sequences // n_parties
        sizes = [base] * n_parties
    else:
        rng = np.random.default_rng(seed)
        raw = np.exp(rng.uniform(np.log(min_frac), 0.0, n_parties))
        raw = raw / raw.sum() * total_sequences
        sizes = np.maximum(raw.astype(int), 1).tolist()
    # distribute rounding remainder
    sizes[0] += total_sequences - sum(sizes)
    return sizes


def partition_indices(
    labels: np.ndarray, n_parties: int, alpha: float = 0.3, seed: int = 0
) -> List[np.ndarray]:
    """Dirichlet partition of an existing dataset by its domain labels:
    every index is assigned to exactly one party."""
    rng = np.random.default_rng(seed)
    n_domains = int(labels.max()) + 1
    mixes = rng.dirichlet(np.full(n_parties, alpha), size=n_domains)  # (D,P)
    parts: List[List[int]] = [[] for _ in range(n_parties)]
    for d in range(n_domains):
        idx = np.flatnonzero(labels == d)
        rng.shuffle(idx)
        cuts = (np.cumsum(mixes[d])[:-1] * len(idx)).astype(int)
        for p, chunk in enumerate(np.split(idx, cuts)):
            parts[p].extend(chunk.tolist())
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]
