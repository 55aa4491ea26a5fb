"""Minimal deterministic batching loader over in-memory numpy datasets."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class Loader:
    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, drop_remainder: bool = True):
        self.data = {k: v for k, v in data.items() if k != "domains"}
        self.n = len(next(iter(self.data.values())))
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        if self.drop_remainder:
            # a dataset smaller than one batch still yields one (partial)
            # batch — tiny parties must be able to train (§2.3)
            return max(1, self.n // self.batch_size) if self.n else 0
        return -(-self.n // self.batch_size)

    def epoch(self, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield {k: v[sel] for k, v in self.data.items()}
