"""Aggregation-time estimation (§5.4, Fig. 6 line 13).

t_agg = (N_parties * t_pair) / (C_agg * N_agg) + M / B_dc

t_pair — the time to fuse ONE pair of model updates — is measured offline by
generating random updates of the job's model shape and timing the fusion
kernel (``measure_t_pair``). For GPU/TPU aggregation the number of usable
cores is bounded by how many updates fit in accelerator memory
(``usable_cores``).

Two sources of t_pair, in priority order:

1. **Measured kernel cost table** (``cost_table=KernelCostTable``): t_pair
   interpolated from the CUDA fusion kernels' timings per model size
   (`repro_torch.kernels.autotune`). This closes the sim-to-real loop — the
   simulator prices fuse work from measured hardware, not config constants.
2. **Config constant** (``t_pair_s``): the historical default; every golden
   baseline runs this path and is bit-identical to pre-cost-table builds.

Online calibration semantics (``calibrate``): observed aggregation
durations re-fit the estimate **asymmetrically**:

* *Up moves immediately* (half-way blend). Under-estimating t_agg starts
  drains too late and hurts the SLA, so a single slow observation counts.
* *Down moves only after a sustained run* (``decay_patience`` consecutive
  low observations), then decays by at most ``decay_rate`` per observation,
  floored at the largest t_pair the low run itself implied. Gated-round
  observations systematically under-measure (tail drains cover only part of
  the fused updates), so one low sample is likely a measurement artifact —
  but a sustained run means the estimate is inflated (e.g. one GC-pause
  outlier) and MUST recover, or every later t_agg stays mispriced forever.
  (The previous implementation ratcheted: ``max(new, current)`` could never
  re-fit downward.)

With a cost table the same blend calibrates a dimensionless ``calib_scale``
multiplier on top of the measured curve instead of mutating t_pair itself,
so one job's congestion never corrupts the hardware measurement.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

from repro_torch.core.jobspec import FLJobSpec

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids import weight
    from repro_torch.kernels.autotune import KernelCostTable


@dataclasses.dataclass(frozen=True)
class AggregatorResources:
    """Resources available for one aggregation deployment."""

    n_aggregators: int = 1  # N_agg: containers / pods
    cores_per_aggregator: int = 2  # C_agg: usable CPU/GPU cores each
    intra_dc_bw: float = 1.25e9  # B_dc, bytes/s (10 Gb/s)
    accelerator_mem_bytes: Optional[float] = None  # GPU/TPU memory bound


def usable_cores(res: AggregatorResources, model_bytes: int) -> int:
    """C_agg, clamped by how many updates fit in accelerator memory (§5.4).

    The fit bound reserves one model-sized slot for the accumulator, so an
    exact fit (memory == model_bytes) leaves fit == 0 and clamps to the
    serial floor of 1 core."""
    c = res.cores_per_aggregator
    if res.accelerator_mem_bytes:
        fit = int(res.accelerator_mem_bytes // max(model_bytes, 1)) - 1
        c = max(1, min(c, fit))
    return c


def measure_t_pair(
    fuse_pair: Callable[[np.ndarray, np.ndarray], np.ndarray],
    model_bytes: int,
    *,
    trials: int = 3,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Offline t_pair measurement: fuse randomly-generated updates (§5.4).

    The warmup call is blocked before the first timed trial starts —
    JAX dispatch is async, so an unblocked warmup's device work would
    bleed into (and inflate) trial 0, and this number feeds the simulator.
    Median of ``trials >= 3`` so one descheduling blip cannot skew it."""
    rng = rng or np.random.default_rng(0)
    trials = max(trials, 3)
    n = max(model_bytes // 4, 1)  # fp32 elements
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    warm = fuse_pair(a, b)  # warmup (jit etc.)
    if hasattr(warm, "block_until_ready"):
        warm.block_until_ready()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fuse_pair(a, b)
        if hasattr(out, "block_until_ready"):
            out.block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclasses.dataclass
class AggregationEstimator:
    """Estimates t_agg for a job given measured t_pair and resources.

    ``cost_table`` (optional): a measured `KernelCostTable`; when present,
    per-job t_pair comes from the table's interpolated kernel timings
    (times ``calib_scale``) and ``t_pair_s`` is only the legacy fallback.
    """

    t_pair_s: float
    resources: AggregatorResources = dataclasses.field(
        default_factory=AggregatorResources
    )
    cost_table: Optional["KernelCostTable"] = None
    # asymmetric calibration knobs (see module docstring)
    decay_patience: int = 12
    decay_rate: float = 0.5
    # per-run calibration state: deliberately init=False so
    # dataclasses.replace() hands each job/vehicle a fresh calibration run
    calib_scale: float = dataclasses.field(default=1.0, init=False)
    _low_streak: int = dataclasses.field(default=0, init=False)
    _low_high: float = dataclasses.field(default=0.0, init=False)

    def t_pair_for(self, model_bytes: int) -> float:
        """Effective t_pair for one job's model size.

        Measured-table path: interpolated kernel timing x calib_scale.
        Constant path: the calibrated scalar ``t_pair_s`` (size-blind,
        exactly the historical behaviour)."""
        if self.cost_table is not None:
            return self.cost_table.t_pair(model_bytes) * self.calib_scale
        return self.t_pair_s

    def t_agg(self, job: FLJobSpec, n_updates: Optional[int] = None) -> float:
        n = n_updates if n_updates is not None else job.n_parties
        res = self.resources
        c_agg = usable_cores(res, job.model_bytes)
        t_pair = self.t_pair_for(job.model_bytes)
        compute = (n * t_pair) / (c_agg * res.n_aggregators)
        comm = job.model_bytes / res.intra_dc_bw
        return compute + comm

    def _blend(self, current: float, new: float) -> float:
        """Asymmetric re-fit: fast up, patience-gated bounded decay down."""
        if new >= current:
            # late aggregation hurts SLA more than an early start wastes
            # resources: move half-way up immediately
            self._low_streak = 0
            self._low_high = 0.0
            return 0.5 * (current + new)
        self._low_streak += 1
        self._low_high = max(self._low_high, new)
        if self._low_streak < self.decay_patience:
            return current  # likely a partial/under-measured observation
        # sustained low run: the estimate is inflated; decay by at most
        # decay_rate per observation, never below the run's own maximum
        return max(current * self.decay_rate, self._low_high)

    def calibrate(self, observed_t_agg: float, job: FLJobSpec,
                  n_updates: int) -> None:
        """Feed back an observed aggregation duration to re-fit t_pair."""
        res = self.resources
        c_agg = usable_cores(res, job.model_bytes)
        comm = job.model_bytes / res.intra_dc_bw
        compute = max(observed_t_agg - comm, 1e-9)
        new_t_pair = compute * c_agg * res.n_aggregators / max(n_updates, 1)
        if self.cost_table is not None:
            base = self.cost_table.t_pair(job.model_bytes)
            if base > 0:
                self.calib_scale = self._blend(
                    self.calib_scale, new_t_pair / base)
            return
        self.t_pair_s = self._blend(self.t_pair_s, new_t_pair)
