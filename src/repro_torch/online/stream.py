"""Arrival streams: unbounded job sources for the online control plane.

The batch vehicles drain a fully-known ``WorkloadTrace``; the online
control plane (``repro.online.controller``) instead *pulls* jobs from an
``ArrivalStream`` one at a time, scheduling each arrival as a simulator
event only once the previous one has fired — so the stream may be
unbounded (or fed live) without materialising a trace up front.

Two adapters ship:

``TraceStream``
    replays a ``WorkloadTrace`` open-loop. ``timing="trace"`` (default)
    keeps every job's recorded ``submit_s`` — an exact open-loop replay of
    the closed trace, under which the paired-comparison guarantee holds:
    the per-party arrival sequences are identical to batch
    ``Platform.submit_fleet`` on the same trace (locked by the conformance
    property test). ``timing="poisson"`` / ``timing="uniform"`` re-time the
    jobs with inter-arrival gaps drawn from a (optionally diurnal and
    bursty) rate process — the load generator for autoscaler/admission
    scenarios.

``StreamHandle``
    programmatic injection: a live queue the caller feeds with
    ``submit(job_trace)`` while the service runs, and ends with
    ``close()``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Deque, Optional, Tuple

import numpy as np

from repro_torch.fleet.traces import JobTrace, WorkloadTrace

#: (arrival time, job) produced by a stream pull
Arrival = Tuple[float, JobTrace]

STREAM_TIMINGS = ("trace", "poisson", "uniform")


class ArrivalStream:
    """Protocol for unbounded job sources consumed by ``OnlineController``.

    The controller pulls sequentially: it calls ``next_job(now)`` once,
    schedules the returned arrival, and pulls again only after that event
    fires — implementations therefore only need to produce one arrival at
    a time, with non-decreasing times. ``next_job`` returns ``None`` when
    nothing is available *right now*; ``closed`` distinguishes "exhausted
    for good" (the controller may quiesce) from "awaiting injection" (a
    ``StreamHandle`` that may still be fed). Push-style streams call the
    waker registered via ``bind_waker`` when new work appears so the
    controller re-pulls without polling.
    """

    def next_job(self, now: float) -> Optional[Arrival]:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        """True when the stream will never produce another job."""
        raise NotImplementedError

    @property
    def will_close(self) -> bool:
        """True when the stream is guaranteed to end eventually (it may
        still hold undelivered jobs). Pull-only streams always end; a
        ``StreamHandle`` ends only once ``close()``d — until then
        ``drain()`` would never return."""
        return True

    def bind_waker(self, waker: Callable[[Optional[float]], None]) -> None:
        """Register the controller's re-pull callback (push streams only)."""


class TraceStream(ArrivalStream):
    """Replay a ``WorkloadTrace``'s jobs as an open-loop arrival stream.

    timing="trace"     arrive at the recorded ``submit_s`` (exact replay;
                       the paired-comparison guarantee vs ``submit_fleet``)
    timing="poisson"   inter-arrival gaps ~ Exp(rate(t)), seeded
    timing="uniform"   deterministic gaps of 1/rate(t)

    For the re-timed modes the instantaneous arrival rate is

        rate(t) = (1 / mean_interarrival_s) * diurnal(t) * burst(t)
        diurnal(t) = 1 + diurnal_amplitude * sin(2*pi*t / diurnal_period_s)
        burst(t)   = burst_factor   for burst_start_s <= t < burst_start_s
                                    + burst_len_s, else 1

    and ``repeat`` cycles the trace's job list that many times (ids get a
    ``#<cycle>`` suffix so every admitted job stays unique). The rate
    process depends only on the clock — never on downstream completion —
    so two strategies fed the same stream see identical arrivals.
    """

    def __init__(
        self,
        trace: WorkloadTrace,
        *,
        timing: str = "trace",
        mean_interarrival_s: float = 60.0,
        diurnal_period_s: Optional[float] = None,
        diurnal_amplitude: float = 0.0,
        burst: Optional[Tuple[float, float, float]] = None,
        seed: int = 0,
        repeat: int = 1,
    ):
        if timing not in STREAM_TIMINGS:
            raise ValueError(
                f"timing must be one of {STREAM_TIMINGS}, got {timing!r}")
        if mean_interarrival_s <= 0.0:
            raise ValueError("mean_interarrival_s must be > 0")
        if not 0.0 <= diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if burst is not None:
            start, length, factor = burst
            if length <= 0.0 or factor <= 0.0 or start < 0.0:
                raise ValueError(
                    f"burst must be (start_s>=0, len_s>0, factor>0), "
                    f"got {burst!r}")
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        if repeat > 1 and timing == "trace":
            raise ValueError(
                "repeat > 1 needs an open-loop timing (poisson/uniform); "
                "trace timing would replay past submit times")
        self.timing = timing
        self.mean_interarrival_s = mean_interarrival_s
        self.diurnal_period_s = diurnal_period_s
        self.diurnal_amplitude = diurnal_amplitude
        self.burst = burst
        self._rng = np.random.default_rng(seed)
        self._queue: Deque[JobTrace] = collections.deque()
        if timing == "trace":
            # stable sort: same-submit_s ties keep trace order, matching
            # FleetRunner's construction-time scheduling order
            self._queue.extend(
                sorted(trace.jobs, key=lambda jt: jt.submit_s))
        else:
            for cycle in range(repeat):
                for jt in trace.jobs:
                    jid = jt.job_id if repeat == 1 \
                        else f"{jt.job_id}#{cycle}"
                    self._queue.append(
                        dataclasses.replace(jt, job_id=jid))
        self._t = 0.0  # last emitted arrival time (open-loop modes)

    def _rate(self, t: float) -> float:
        rate = 1.0 / self.mean_interarrival_s
        if self.diurnal_period_s:
            rate *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        if self.burst is not None:
            start, length, factor = self.burst
            if start <= t < start + length:
                rate *= factor
        return rate

    def next_job(self, now: float) -> Optional[Arrival]:
        if not self._queue:
            return None
        jt = self._queue.popleft()
        if self.timing == "trace":
            return jt.submit_s, jt
        rate = self._rate(self._t)
        gap = (float(self._rng.exponential(1.0 / rate))
               if self.timing == "poisson" else 1.0 / rate)
        self._t += gap
        return self._t, dataclasses.replace(jt, submit_s=self._t)

    @property
    def closed(self) -> bool:
        return not self._queue


class StreamHandle(ArrivalStream):
    """Programmatic injection: feed jobs into a running service.

        handle = StreamHandle()
        svc = platform.serve(handle)
        handle.submit(job_trace)          # arrives at the current sim time
        svc.advance(until=3600.0)
        handle.submit(other, at=7200.0)   # arrives at t=7200
        handle.close()                    # no more jobs; service may drain

    ``submit(jt, at=None)`` enqueues a job arriving at ``max(at, now)``
    (``None`` = as soon as the controller pulls). The handle stays open —
    and the service alive — until ``close()``.
    """

    def __init__(self):
        self._pending: Deque[Tuple[Optional[float], JobTrace]] = \
            collections.deque()
        self._closed = False
        self._waker: Optional[Callable[[Optional[float]], None]] = None

    def submit(self, jt: JobTrace, *, at: Optional[float] = None) -> None:
        if self._closed:
            raise RuntimeError("StreamHandle is closed")
        self._pending.append((at, jt))
        if self._waker is not None:
            self._waker(at)

    def close(self) -> None:
        """End the stream: the service drains and quiesces once every
        already-submitted job completes."""
        self._closed = True
        if self._waker is not None:
            self._waker(None)  # let the controller re-check quiescence

    def bind_waker(self, waker: Callable[[Optional[float]], None]) -> None:
        self._waker = waker

    def next_job(self, now: float) -> Optional[Arrival]:
        if not self._pending:
            return None
        at, jt = self._pending.popleft()
        t = now if at is None else max(at, now)
        return t, dataclasses.replace(jt, submit_s=t)

    @property
    def closed(self) -> bool:
        return self._closed and not self._pending

    @property
    def will_close(self) -> bool:
        # close() was called: the pending backlog is finite and drains
        return self._closed
