"""Counter-based per-party RNG streams (``rng="philox"``) — the vectorized
fleet sampling scheme.

The legacy scheme (``rng="pcg64"``, the default) gives every party its own
sequential ``np.random.default_rng`` stream: exact, but a Python Generator
object and a Python ``sample_round`` call per (party, round) — the fleet
hot path tops out around hundreds of jobs. This module replaces the
*stream construction* so sampling vectorizes without giving up the paired
per-party-stream guarantee:

  * every party owns a **Philox4x64-10 key** spawned from one
    ``SeedSequence((base_seed, job.seed))`` — streams are still per-party
    and deterministic in (seed, party index), so every strategy prices the
    identical arrival sequence (the conformance invariant);
  * the counter is the **round index** and each (party, round) consumes a
    fixed budget of one 4x64 block (4 uniforms) — no sequential state, so
    one numpy call draws a whole (parties x rounds) grid at once;
  * the Philox round function itself is implemented here with vectorized
    ``uint64`` arithmetic and verified bit-for-bit against numpy's own
    ``np.random.Philox`` bit generator (``tests/test_fleet_vector.py``).

Both access paths — the scalar ``sample_round`` the engine vehicle calls
through ``CounterStreamParty`` and the batched per-round rows the
vectorized scheduler path reads — are views of the same presampled grid,
so cross-vehicle arrival parity is exact by construction. An independent
scalar reference (``reference_sample``) recomputes single samples from
scratch for the equivalence property test.

Fixed draw budget per (party, round), block words w0..w3:

  u0 = unit(w0)        dropout check (u0 < dropout_prob -> §2.2 no-show)
  u1 = unit(w1)        intermittent arrival offset in [comm_s, window_s)
  z  = box-muller(open(w1), unit(w2))   gaussian jitter for steady/diurnal/
                                        straggler trains
  u3 = unit(w3)        straggler tail check

where unit(w) = (w >> 11) * 2^-53 in [0, 1) (numpy's double conversion)
and open(w) = ((w >> 11) + 1) * 2^-53 in (0, 1] so log never sees zero.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.fleet.traces import JobTrace, PartyPattern

# Philox4x64 round and Weyl constants (Salmon et al., Random123)
_M0 = np.uint64(0xD2E7470EE14C6C93)
_M1 = np.uint64(0xCA5A826395121157)
_W0 = np.uint64(0x9E3779B97F4A7C15)
_W1 = np.uint64(0xBB67AE8584CAA73B)
_MASK32 = np.uint64(0xFFFFFFFF)
_SH32 = np.uint64(32)
_U53 = 2.0 ** -53


def _mulhilo(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized 64x64 -> 128-bit multiply (hi, lo words), wrapping."""
    lo = a * b
    alo, ahi = a & _MASK32, a >> _SH32
    blo, bhi = b & _MASK32, b >> _SH32
    t = ahi * blo + ((alo * blo) >> _SH32)
    hi = ahi * bhi + (t >> _SH32) + (((t & _MASK32) + alo * bhi) >> _SH32)
    return hi, lo


def philox4x64(
    c0: np.ndarray, c1: np.ndarray, c2: np.ndarray, c3: np.ndarray,
    k0: np.ndarray, k1: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Philox4x64-10: one block per element, vectorized over any shape.

    Bit-identical to ``np.random.Philox`` output for the same (counter,
    key) — locked by test — but computed as plain numpy ``uint64`` math so
    thousands of per-party streams evaluate in one call.
    """
    for i in range(10):
        if i > 0:
            k0 = k0 + _W0
            k1 = k1 + _W1
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(w: np.ndarray) -> np.ndarray:
    """u64 -> float64 in [0, 1), numpy's standard 53-bit conversion."""
    return (w >> np.uint64(11)).astype(np.float64) * _U53


def _unit_open(w: np.ndarray) -> np.ndarray:
    """u64 -> float64 in (0, 1] — safe as a log() argument."""
    return ((w >> np.uint64(11)) + np.uint64(1)).astype(np.float64) * _U53


def party_keys(base_seed: int, job_seed: int, n_parties: int) -> np.ndarray:
    """(P, 2) uint64 per-party Philox keys spawned from one SeedSequence —
    deterministic in (base_seed, job_seed, party index)."""
    ss = np.random.SeedSequence((base_seed, job_seed))
    return ss.generate_state(2 * n_parties, dtype=np.uint64).reshape(-1, 2)


class PhiloxPartySampler:
    """All of one job's party availability, presampled as (P, R) grids.

    One Philox batch over the full (party x round) grid at construction;
    ``round_view`` hands the vectorized scheduler path a whole round as
    arrays, ``sample`` hands the engine vehicle single (party, round)
    entries — the same memory either way, so the two vehicles cannot
    diverge. Grids cost ~17 bytes per (party, round); a 5,000-job default
    trace is ~10 MB.
    """

    def __init__(self, job: JobTrace, base_seed: int = 0):
        if not job.parties:
            raise ValueError(
                f"job {job.job_id!r} has no synthetic parties "
                f"(measured jobs replay exactly; nothing to sample)")
        self.job_id = job.job_id
        self.party_ids: List[str] = list(job.parties)
        pats: List[PartyPattern] = list(job.parties.values())
        P, R = len(pats), job.rounds
        self.n_parties, self.n_rounds = P, R

        def arr(field: str, default: float = 0.0) -> np.ndarray:
            return np.array(
                [getattr(p, field) if getattr(p, field) is not None
                 else default for p in pats], dtype=np.float64)

        mean = arr("mean_train_s")
        jitter = arr("jitter_rel")
        self.comm = arr("comm_s")
        dropout = arr("dropout_prob")
        sprob = arr("straggler_prob")
        sfactor = arr("straggler_factor")
        period = arr("period_s")
        amplitude = arr("amplitude")
        phase = arr("phase_s")
        window = arr("window_s")
        kinds = np.array([p.pattern for p in pats])
        intermittent = kinds == "intermittent"
        diurnal = kinds == "diurnal"
        straggler = kinds == "straggler"

        # one 4x64 block per (party, round): counter = round index,
        # key = the party's spawned stream key
        keys = party_keys(base_seed, job.seed, P)
        rounds = np.arange(R, dtype=np.uint64)[None, :]
        zero = np.zeros((P, R), dtype=np.uint64)
        w0, w1, w2, w3 = philox4x64(
            zero + rounds, zero, zero, zero,
            zero + keys[:, 0:1], zero + keys[:, 1:2])

        col = lambda x: x[:, None]  # (P,) -> (P, 1) for (P, R) broadcasts
        # gaussian jitter via Box-Muller (fixed two-draw budget; the
        # sequential scheme's ziggurat consumes a variable number of words)
        z = np.sqrt(-2.0 * np.log(_unit_open(w1))) * np.cos(
            2.0 * np.pi * _unit(w2))
        t = col(mean) * (1.0 + col(jitter) * z)
        # diurnal modulation phased on the NOMINAL round cadence — same
        # paired-comparison reasoning as the sequential sampler
        t_nom = rounds.astype(np.float64) * col(mean) + col(phase)
        t = np.where(
            col(diurnal),
            t * (1.0 + col(amplitude)
                 * np.sin(2.0 * np.pi * t_nom / np.where(
                     col(period) > 0.0, col(period), 1.0))),
            t)
        t = np.where(
            col(straggler) & (_unit(w3) < col(sprob)), t * col(sfactor), t)
        t = np.maximum(t, 1e-3)
        # §4.3 intermittent: the update lands uniformly inside the window
        t = np.where(
            col(intermittent),
            _unit(w1) * (col(window) - col(self.comm)),
            t)
        self.train: np.ndarray = t  # (P, R) train seconds
        self.noshow: np.ndarray = (col(dropout) > 0.0) & (
            _unit(w0) < col(dropout))  # (P, R) §2.2 no-shows

    # ---- batched access (vectorized scheduler path) ------------------------
    def round_view(self, round_idx: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(train_s (P,), comm_s (P,), noshow (P,)) for one round."""
        if not 0 <= round_idx < self.n_rounds:
            raise IndexError(
                f"no round {round_idx} for {self.job_id} "
                f"(have {self.n_rounds})")
        return self.train[:, round_idx], self.comm, self.noshow[:, round_idx]

    # ---- scalar access (engine vehicle / conformance) ----------------------
    def sample(self, party_idx: int, round_idx: int
               ) -> Optional[Tuple[float, float]]:
        if not 0 <= round_idx < self.n_rounds:
            raise IndexError(
                f"no round {round_idx} for {self.job_id} "
                f"(have {self.n_rounds})")
        if self.noshow[party_idx, round_idx]:
            return None
        return (float(self.train[party_idx, round_idx]),
                float(self.comm[party_idx]))


def reference_sample(job: JobTrace, base_seed: int, party_idx: int,
                     round_idx: int) -> Optional[Tuple[float, float]]:
    """Independent scalar recomputation of one (party, round) sample —
    the equivalence oracle for the vectorized grids (property test). Runs
    the same kernel on 1-element arrays but rebuilds keys, masks and
    transforms from scratch for a single party."""
    # same key table (spawned per job), single-party slice of the grid math
    keys = party_keys(base_seed, job.seed, len(job.parties))
    pat = list(job.parties.values())[party_idx]
    c0 = np.array([round_idx], dtype=np.uint64)
    zero = np.zeros(1, dtype=np.uint64)
    w0, w1, w2, w3 = philox4x64(
        c0, zero, zero, zero,
        np.array([keys[party_idx, 0]]), np.array([keys[party_idx, 1]]))
    if pat.dropout_prob > 0.0 and float(_unit(w0)[0]) < pat.dropout_prob:
        return None
    if pat.pattern == "intermittent":
        train = float(_unit(w1)[0]) * (pat.window_s - pat.comm_s)
        return train, pat.comm_s
    z = float((np.sqrt(-2.0 * np.log(_unit_open(w1)))
               * np.cos(2.0 * np.pi * _unit(w2)))[0])
    t = pat.mean_train_s * (1.0 + pat.jitter_rel * z)
    if pat.pattern == "diurnal":
        t_nom = round_idx * pat.mean_train_s + pat.phase_s
        t = t * (1.0 + pat.amplitude * float(np.sin(np.float64(
            2.0 * np.pi * t_nom / (pat.period_s if pat.period_s > 0.0
                                   else 1.0)))))
    if pat.pattern == "straggler" and float(_unit(w3)[0]) < pat.straggler_prob:
        t = t * pat.straggler_factor
    return max(t, 1e-3), pat.comm_s
