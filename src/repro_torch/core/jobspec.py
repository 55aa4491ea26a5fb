"""FL job specification — the inputs §5.1/§5.2 of the paper requires.

Parties agree on model architecture, hyperparameters, aggregation algorithm,
synchronisation frequency, quorum and (for intermittent parties) t_wait, and
send the spec to the aggregation service. Parties additionally report their
mode of participation, measured epoch/minibatch times (or hardware info from
which we regress them) and network bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class PartySpec:
    party_id: str
    mode: str = "active"  # active | intermittent
    # direct measurements (seconds) — preferred (§5.2(ii))
    epoch_time_s: Optional[float] = None
    minibatch_time_s: Optional[float] = None
    dataset_size: int = 0  # number of local examples
    batch_size: int = 32
    # hardware info fallback for linear-regression estimation (§5.3)
    hardware: Optional[str] = None  # key into a measured hardware table
    n_accelerators: int = 1
    # measured average bandwidths, bytes/s (§5.2(iii))
    bw_down: float = 125e6  # aggregator -> party
    bw_up: float = 125e6  # party -> aggregator

    def provides_timing(self) -> bool:
        return self.epoch_time_s is not None or self.minibatch_time_s is not None


@dataclasses.dataclass
class FLJobSpec:
    job_id: str
    model_arch: str  # registry id, e.g. "qwen3-0.6b"
    model_bytes: int  # size of one flattened model update (M in the paper)
    aggregation_algorithm: str = "fedavg"  # fedavg | fedsgd | fedprox
    # synchronisation frequency: "epoch" or an int = every N minibatches
    sync_frequency: str | int = "epoch"
    rounds: int = 50
    quorum_fraction: float = 1.0  # min fraction of parties per round
    t_wait_s: Optional[float] = None  # intermittent-party window (§4.3)
    parties: Dict[str, PartySpec] = dataclasses.field(default_factory=dict)
    # learning hyperparameters (agreed up front; the aggregator needs them
    # only to reproduce the job, not for scheduling)
    lr: float = 1e-2
    batch_size: int = 32
    prox_mu: float = 0.0  # FedProx proximal term

    @property
    def n_parties(self) -> int:
        return len(self.parties)

    @property
    def quorum(self) -> int:
        return max(1, int(self.quorum_fraction * self.n_parties))

    def has_intermittent(self) -> bool:
        return any(p.mode == "intermittent" for p in self.parties.values())

    def validate(self) -> None:
        assert self.n_parties >= 1, "job needs parties"
        assert self.model_bytes > 0
        if self.has_intermittent():
            assert self.t_wait_s, "intermittent parties require t_wait (§4.3)"
        for p in self.parties.values():
            if p.mode == "active" and not p.provides_timing() and not p.hardware:
                raise ValueError(
                    f"active party {p.party_id} must provide timing or hardware "
                    f"info (§5.2)"
                )
