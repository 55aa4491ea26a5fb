"""Simulated per-job parties (``repro.fleet``).

A ``SimulatedParty`` is the event process behind one party of one fleet
job: each round it samples its availability pattern (train time, comm
time, or a no-show) from its own deterministic RNG stream. The same party
objects drive BOTH execution vehicles:

  * the Fig. 6 ``JITScheduler`` in arrival-gated mode — ``FleetRunner``
    schedules one simulator event per sampled arrival, which lands in
    ``JITScheduler.deliver_update`` (online t_rnd calibration + quorum
    gating) or ``party_no_show``;
  * the per-job ``RoundEngine`` baselines (eager-AO, eager-λ, ...) — via
    the ``FleetArrivalSource`` adapter, which plugs the parties into the
    engine's ``ArrivalSource`` seam.

Because each party owns one RNG stream sampled once per round in a fixed
order, every strategy prices the *same* arrival sequence — the comparison
is paired, not merely distribution-matched. ``MeasuredParty`` replays a
recorded real run (``JobTrace.measured_rounds``) through the same
interface.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import Simulator
from repro_torch.core.strategies import ArrivalSource
from repro_torch.fleet.traces import JobTrace, MeasuredRound, PartyPattern

#: Conformance hook: called once per (job, party, round) with the sampled
#: availability — ``None`` for a §2.2 no-show, else ``(train_s, comm_s)``.
#: Both fleet vehicles call it in the same order, so two runs over the same
#: trace can be checked for identical arrival sequences
#: (``repro.fleet.conformance``).
ArrivalRecorder = Callable[[str, str, int, Optional[Tuple[float, float]]],
                           None]


class SimulatedParty:
    """One party's per-round availability process (pattern + RNG stream)."""

    def __init__(self, party_id: str, pattern: PartyPattern, seed):
        self.party_id = party_id
        self.pattern = pattern
        self.rng = np.random.default_rng(seed)

    def sample_round(self, round_idx: int, round_start_s: float
                     ) -> Optional[Tuple[float, float]]:
        """(train_s, comm_s) for this round, or None on a no-show (§2.2)."""
        p = self.pattern
        if p.dropout_prob and self.rng.uniform() < p.dropout_prob:
            return None
        if p.pattern == "intermittent":
            # the paper's §4.3 random-update scheme: the update lands at a
            # uniformly random time inside the round window
            offset = float(self.rng.uniform(p.comm_s, p.window_s))
            return offset - p.comm_s, p.comm_s
        t = p.mean_train_s * (
            1.0 + float(self.rng.normal(0.0, p.jitter_rel)))
        if p.pattern == "diurnal":
            # phase advances on the NOMINAL round cadence (round_idx x mean
            # train time), not the realized round start: realized starts
            # differ across strategies, which would break the paired-
            # comparison guarantee for diurnal jobs
            t_nom = round_idx * p.mean_train_s + p.phase_s
            t *= 1.0 + p.amplitude * math.sin(
                2.0 * math.pi * t_nom / p.period_s)
        if p.pattern == "straggler" and (
                self.rng.uniform() < p.straggler_prob):
            t *= p.straggler_factor
        return max(t, 1e-3), p.comm_s


class MeasuredParty:
    """Replays one party's recorded (train_s, comm_s) per round exactly."""

    def __init__(self, party_id: str, rounds: List[MeasuredRound]):
        self.party_id = party_id
        self._rounds = rounds

    def sample_round(self, round_idx: int, round_start_s: float
                     ) -> Optional[Tuple[float, float]]:
        if round_idx >= len(self._rounds):
            raise IndexError(
                f"no measured round {round_idx} for {self.party_id} "
                f"(have {len(self._rounds)})")
        return self._rounds[round_idx].get(self.party_id)


class CounterStreamParty:
    """One party backed by a shared per-job ``PhiloxPartySampler`` grid
    (``rng="philox"``).

    Presents the same ``sample_round`` interface as ``SimulatedParty`` —
    the engine vehicle and conformance recorder call it scalar-wise — but
    the values come from the job's presampled (party x round) grid, the
    very same arrays the vectorized ``FleetRunner`` path reads in bulk.
    One object per party keeps the per-party-stream framing (and the
    party's index into the grid); there is no per-object RNG state.
    """

    def __init__(self, party_id: str, index: int, sampler):
        self.party_id = party_id
        self.index = index
        self.sampler = sampler  # PhiloxPartySampler, shared across the job

    def sample_round(self, round_idx: int, round_start_s: float
                     ) -> Optional[Tuple[float, float]]:
        return self.sampler.sample(self.index, round_idx)


def build_party_processes(
    job: JobTrace, base_seed: int = 0, rng: str = "pcg64",
) -> Tuple[Dict[str, object], Optional[object]]:
    """Party processes for one job, plus the shared sampler (philox only).

    ``rng="pcg64"`` (default) is the original scheme — one sequential
    ``np.random.default_rng((base_seed, job.seed, i))`` stream per party,
    kept as the default so existing traces and goldens stay bit-identical.
    ``rng="philox"`` presamples the whole job on counter-based streams
    (``repro.fleet.streams``), enabling the vectorized fleet fast path;
    the second return value is then the job's ``PhiloxPartySampler``.
    Measured jobs replay exactly under either setting.
    """
    if job.measured_rounds:
        return ({pid: MeasuredParty(pid, job.measured_rounds)
                 for pid in job.party_ids}, None)
    if rng == "philox":
        from repro_torch.fleet.streams import PhiloxPartySampler
        sampler = PhiloxPartySampler(job, base_seed)
        return ({pid: CounterStreamParty(pid, i, sampler)
                 for i, pid in enumerate(job.parties)}, sampler)
    if rng != "pcg64":
        raise ValueError(f"rng must be 'pcg64' or 'philox', got {rng!r}")
    return ({
        pid: SimulatedParty(pid, pat, seed=(base_seed, job.seed, i))
        for i, (pid, pat) in enumerate(job.parties.items())
    }, None)


def build_parties(job: JobTrace, base_seed: int = 0,
                  rng: str = "pcg64") -> Dict[str, object]:
    """One party process per trace party, with deterministic RNG streams
    derived from (base_seed, job.seed, party index)."""
    return build_party_processes(job, base_seed, rng)[0]


class FleetArrivalSource(ArrivalSource):
    """Adapter: a job's simulated parties as a ``RoundEngine`` arrival
    source, so every registered deployment strategy prices the same fleet
    arrival sequences the JIT scheduler vehicle sees.

    Announces presence: a ``None`` sample is reported to the engine as an
    up-front §2.2 no-show (``RoundEngine.announce_no_show``), the same
    per-round knowledge ``FleetRunner`` gives the scheduler vehicle via
    ``party_no_show`` — so dropout-pattern comparisons are presence-fair.
    """

    announces_presence = True

    def __init__(self, sim: Simulator, parties: Dict[str, object], *,
                 job_id: str = "", recorder: Optional[ArrivalRecorder] = None):
        self.sim = sim
        self.parties = parties
        self.job_id = job_id
        self.recorder = recorder
        self._idx = 0
        self._start = 0.0
        self._cur: Dict[str, Tuple[float, float]] = {}

    def start_round(self, round_idx: int) -> None:
        self._idx = round_idx
        self._start = self.sim.now
        self._cur = {}

    def sample_arrival(self, pid: str) -> Optional[float]:
        rec = self.parties[pid].sample_round(self._idx, self._start)
        if self.recorder is not None:
            self.recorder(self.job_id, pid, self._idx, rec)
        if rec is None:
            return None
        self._cur[pid] = rec
        train, comm = rec
        return train + comm

    def sample_train_time(self, pid: str, arrival_offset: float) -> float:
        return self._cur[pid][0]
