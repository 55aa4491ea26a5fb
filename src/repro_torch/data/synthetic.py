"""Synthetic language-modelling data with learnable structure.

Each "domain" d has its own first-order Markov transition structure over the
vocabulary (a mixture of a shared Zipf unigram model and a domain-specific
deterministic successor pattern). Training reduces loss well below the
unigram entropy, so federated-vs-local utility comparisons are meaningful,
and domains give a natural non-IID axis for partitioning across parties.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int = 512
    n_domains: int = 10
    seq_len: int = 64
    zipf_a: float = 1.3
    # probability of following the domain-specific successor chain rather
    # than drawing from the shared unigram
    chain_p: float = 0.75
    n_codebooks: int = 0  # audio-style multi-codebook tokens


class SyntheticLM:
    def __init__(self, cfg: SyntheticLMConfig, seed: int = 0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # per-domain successor permutation (the learnable structure)
        self.successor = np.stack(
            [rng.permutation(v) for _ in range(cfg.n_domains)]
        )

    def sample_sequence(self, domain: int, rng: np.random.Generator
                        ) -> np.ndarray:
        cfg = self.cfg
        v = cfg.vocab_size
        length = cfg.seq_len + 1  # +1 so tokens/labels can be shifted
        k = max(cfg.n_codebooks, 1)
        out = np.empty((length, k), dtype=np.int32)
        tok = rng.choice(v, size=k, p=self.unigram)
        out[0] = tok
        for t in range(1, length):
            follow = rng.random(k) < cfg.chain_p
            nxt = np.where(
                follow,
                self.successor[domain][tok],
                rng.choice(v, size=k, p=self.unigram),
            )
            out[t] = nxt
            tok = nxt
        return out if cfg.n_codebooks else out[:, 0]

    def make_dataset(self, domain_mix: np.ndarray, n_sequences: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
        """domain_mix: probability over domains for this party's data."""
        rng = np.random.default_rng(seed)
        seqs, domains = [], []
        for _ in range(n_sequences):
            d = int(rng.choice(len(domain_mix), p=domain_mix))
            seqs.append(self.sample_sequence(d, rng))
            domains.append(d)
        arr = np.stack(seqs)
        return {
            "tokens": arr[:, :-1],
            "labels": arr[:, 1:],
            "domains": np.asarray(domains, np.int32),
        }
