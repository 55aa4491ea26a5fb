"""Predicting the next model update (§4, §5.3).

Two exploited properties of ML training workloads:
  * Periodicity — minibatch/epoch time is constant across epochs on fixed
    data + hardware (paper Fig. 3).
  * Linearity — minibatch time is linear in batch size, epoch time is linear
    in dataset size (paper Fig. 4), so times can be regressed from history
    or from hardware throughput tables.

t_train:   epoch time, or N_mb * t_mb, or t_wait for intermittent parties.
t_comm:    M/B_down + M/B_up.
t_upd:     t_train + t_comm                      (Fig. 6 line 10)
t_rnd:     max_i t_upd^(i)                       (Fig. 6 line 11)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.jobspec import FLJobSpec, PartySpec


# --------------------------------------------------------------------------
# online linear regression  y = a*x + b  (epoch_time vs dataset_size, or
# minibatch_time vs batch_size) with exact least squares over the history.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LinearEstimator:
    """Incremental least-squares fit of y = slope*x + intercept."""

    n: int = 0
    sx: float = 0.0
    sy: float = 0.0
    sxx: float = 0.0
    sxy: float = 0.0

    def observe(self, x: float, y: float) -> None:
        self.n += 1
        self.sx += x
        self.sy += y
        self.sxx += x * x
        self.sxy += x * y

    @property
    def slope(self) -> float:
        d = self.n * self.sxx - self.sx * self.sx
        if self.n < 2 or abs(d) < 1e-12:
            return 0.0
        return (self.n * self.sxy - self.sx * self.sy) / d

    @property
    def intercept(self) -> float:
        if self.n == 0:
            return 0.0
        if self.n < 2:
            return self.sy / self.n
        return (self.sy - self.slope * self.sx) / self.n

    def predict(self, x: float) -> float:
        if self.n == 0:
            raise ValueError("no observations")
        if self.n == 1:
            return self.sy  # single point: constant prediction
        return self.slope * x + self.intercept


# --------------------------------------------------------------------------
# periodicity tracker: exponential-window mean/std of per-round times,
# flags drift (data/hardware change) and re-fits.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PeriodicTracker:
    alpha: float = 0.3  # EWMA weight of the newest observation
    mean: Optional[float] = None
    var: float = 0.0
    count: int = 0

    def observe(self, t: float) -> None:
        self.count += 1
        if self.mean is None:
            self.mean, self.var = t, 0.0
            return
        delta = t - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)

    def predict(self) -> float:
        if self.mean is None:
            raise ValueError("no observations")
        return self.mean

    @property
    def std(self) -> float:
        return float(np.sqrt(max(self.var, 0.0)))

    def is_stable(self, rel_tol: float = 0.15) -> bool:
        """Periodicity check: std within rel_tol of the mean."""
        if self.mean is None or self.count < 3:
            return False
        return self.std <= rel_tol * abs(self.mean)


# --------------------------------------------------------------------------
# hardware throughput table for the regression fallback (§5.2(ii)): when a
# party only reports hardware, estimate minibatch time from measured
# examples/sec for that hardware class.
# --------------------------------------------------------------------------
DEFAULT_HARDWARE_THROUGHPUT: Dict[str, float] = {
    # examples/second for the reference model; measured offline (§5.3)
    "cpu-2vcpu": 8.0,
    "cpu-4vcpu": 15.0,
    "cpu-8core-i9": 30.0,
    "gpu-k80": 120.0,
    "gpu-v100": 600.0,
    "tpu-v5e-chip": 2400.0,
}


class UpdatePredictor:
    """Per-job predictor of when each party's next update arrives (§5.3).

    Combines the spec-provided timings with online observations: every
    completed round feeds the actual training time back into both the
    periodicity tracker and the linearity regressors, so predictions adapt
    to dataset growth and hardware changes.
    """

    def __init__(
        self,
        job: FLJobSpec,
        hardware_table: Optional[Dict[str, float]] = None,
    ):
        self.job = job
        self.hw = hardware_table or DEFAULT_HARDWARE_THROUGHPUT
        self.period: Dict[str, PeriodicTracker] = {
            pid: PeriodicTracker() for pid in job.parties
        }
        # epoch_time vs dataset_size (one regressor per party)
        self.lin_data: Dict[str, LinearEstimator] = {
            pid: LinearEstimator() for pid in job.parties
        }
        # last dataset size each party trained on (drift detection, §4.2)
        self.last_size: Dict[str, float] = {}

    # -- feedback ------------------------------------------------------------
    def observe_round(self, party_id: str, train_time_s: float,
                      dataset_size: Optional[int] = None) -> None:
        self.period[party_id].observe(train_time_s)
        p = self.job.parties[party_id]
        size = float(dataset_size if dataset_size is not None
                     else p.dataset_size)
        self.lin_data[party_id].observe(size, train_time_s)
        self.last_size[party_id] = size

    # -- t_train (Fig. 6 line 7) ----------------------------------------------
    def t_train(self, party_id: str) -> float:
        p = self.job.parties[party_id]
        if p.mode == "intermittent":
            assert self.job.t_wait_s is not None
            return float(self.job.t_wait_s)
        tracker = self.period[party_id]
        # §4.2 linearity: when the party's reported dataset size has changed
        # since the last observation, the EWMA lags — predict the NEW epoch
        # time from the fitted time-vs-size regression instead.
        lin = self.lin_data[party_id]
        last = self.last_size.get(party_id)
        if (last is not None and lin.n >= 3
                and abs(p.dataset_size - last) > 1e-9
                and abs(lin.slope) > 1e-12):
            return max(lin.predict(float(p.dataset_size)), 1e-6)
        if tracker.is_stable():
            # periodicity: best predictor is the observed per-round time
            return tracker.predict()
        if self.job.sync_frequency == "epoch":
            if p.epoch_time_s is not None:
                return p.epoch_time_s
            if p.minibatch_time_s is not None:
                n_mb = max(1, p.dataset_size // max(p.batch_size, 1))
                return p.minibatch_time_s * n_mb
            return self._regress_epoch_time(p)
        n_mb = int(self.job.sync_frequency)
        if p.minibatch_time_s is not None:
            return p.minibatch_time_s * n_mb
        if p.epoch_time_s is not None:
            total_mb = max(1, p.dataset_size // max(p.batch_size, 1))
            return p.epoch_time_s / total_mb * n_mb
        return self._regress_epoch_time(p) / max(
            1, p.dataset_size // max(p.batch_size, 1)
        ) * n_mb

    def _regress_epoch_time(self, p: PartySpec) -> float:
        """Linearity fallback: epoch time from hardware throughput or from
        the fitted epoch-time-vs-dataset-size regression."""
        lin = self.lin_data[p.party_id]
        if lin.n >= 2:
            return max(lin.predict(float(p.dataset_size)), 1e-6)
        if p.hardware and p.hardware in self.hw:
            thr = self.hw[p.hardware] * max(p.n_accelerators, 1)
            return p.dataset_size / thr
        raise ValueError(
            f"party {p.party_id}: no timing, no usable hardware info"
        )

    # -- t_comm / t_upd / t_rnd -------------------------------------------------
    def t_comm(self, party_id: str) -> float:
        p = self.job.parties[party_id]
        m = self.job.model_bytes
        return m / p.bw_down + m / p.bw_up  # Fig. 6 line 9

    def t_upd(self, party_id: str) -> float:
        return self.t_train(party_id) + self.t_comm(party_id)  # line 10

    def t_rnd(self) -> float:
        return max(self.t_upd(pid) for pid in self.job.parties)  # line 11

    def per_party(self) -> Dict[str, float]:
        return {pid: self.t_upd(pid) for pid in self.job.parties}


class VectorizedUpdatePredictor:
    """Array-backed ``UpdatePredictor`` for the fleet fast path.

    Maintains per-party EWMA mean/var/count as numpy arrays and observes a
    whole round of arrivals in one call, reproducing the scalar
    ``PeriodicTracker`` recurrence value-for-value (same float64 ops, same
    0.3 alpha, same count>=3 / std<=0.15*|mean| stability rule). Per-party
    trackers are independent and ``t_rnd`` is only read at the next round
    start, so batch observation at round start is state-equivalent to the
    per-arrival feed — the fast==legacy equality test locks this.

    Restricted to the spec shape fleet traces generate (epoch-sync jobs
    with ``epoch_time_s`` declared and a fixed ``dataset_size``, so the
    §4.2 size-drift regression branch is dead); anything else must use the
    general scalar predictor.
    """

    alpha = 0.3  # matches PeriodicTracker.alpha

    def __init__(self, job: FLJobSpec):
        if job.sync_frequency != "epoch":
            raise ValueError(
                "VectorizedUpdatePredictor supports epoch-sync jobs only; "
                f"got sync_frequency={job.sync_frequency!r}")
        self.job = job
        self.pids: List[str] = list(job.parties)
        self.index: Dict[str, int] = {p: i for i, p in enumerate(self.pids)}
        specs = [job.parties[p] for p in self.pids]
        self.intermittent = np.array(
            [s.mode == "intermittent" for s in specs])
        if bool(self.intermittent.any()) and job.t_wait_s is None:
            raise ValueError("intermittent parties need job.t_wait_s")
        for s in specs:
            if s.mode != "intermittent" and s.epoch_time_s is None:
                raise ValueError(
                    f"party {s.party_id}: VectorizedUpdatePredictor needs a "
                    "declared epoch_time_s (use UpdatePredictor otherwise)")
        self.declared = np.array(
            [s.epoch_time_s if s.epoch_time_s is not None else 0.0
             for s in specs], dtype=np.float64)
        m = job.model_bytes
        self.tcomm = np.array(
            [m / s.bw_down + m / s.bw_up for s in specs], dtype=np.float64)
        self.t_wait = float(job.t_wait_s or 0.0)
        n = len(specs)
        self.mean = np.zeros(n, dtype=np.float64)
        self.var = np.zeros(n, dtype=np.float64)
        self.count = np.zeros(n, dtype=np.int64)

    # -- feedback ------------------------------------------------------------
    def observe_batch(self, idx: np.ndarray, times: np.ndarray) -> None:
        """One round's arrivals: party indices + observed train times.

        Indices must be unique within a call (each party arrives at most
        once per round) — duplicate indices would collapse to one EWMA
        step under fancy-indexed assignment."""
        if len(idx) == 0:
            return
        first = self.count[idx] == 0
        self.count[idx] += 1
        fi = idx[first]
        self.mean[fi] = times[first]
        self.var[fi] = 0.0
        ri = idx[~first]
        if len(ri):
            delta = times[~first] - self.mean[ri]
            self.mean[ri] += self.alpha * delta
            self.var[ri] = (1.0 - self.alpha) * (
                self.var[ri] + self.alpha * delta * delta)

    def observe_round(self, party_id: str, train_time_s: float,
                      dataset_size: Optional[int] = None) -> None:
        """Scalar compatibility path (same signature as UpdatePredictor)."""
        self.observe_batch(np.array([self.index[party_id]]),
                           np.array([float(train_time_s)]))

    # -- t_train / t_comm / t_rnd --------------------------------------------
    def t_upd_all(self) -> np.ndarray:
        std = np.sqrt(np.maximum(self.var, 0.0))
        stable = (self.count >= 3) & (std <= 0.15 * np.abs(self.mean))
        t_train = np.where(self.intermittent, self.t_wait,
                           np.where(stable, self.mean, self.declared))
        return t_train + self.tcomm

    def t_rnd(self) -> float:
        return float(np.max(self.t_upd_all()))  # Fig. 6 line 11

    def per_party(self) -> Dict[str, float]:
        upd = self.t_upd_all()
        return {pid: float(upd[i]) for i, pid in enumerate(self.pids)}
