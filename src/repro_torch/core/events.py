"""Deterministic discrete-event simulation core (virtual clock + heapq).

The cluster, parties and aggregation strategies all run on this clock, which
is what lets us reproduce the paper's 10..10000-party experiments (Figs 7-9)
exactly and quickly on one CPU.

Fleet-scale fast path (``benchmarks/simcore.py``): ``pending`` is a live
O(1) counter (not a heap scan), cancelled entries are compacted out of the
heap once they dominate it (lazy deletion would otherwise let a
cancel-heavy workload — e.g. one deadline timer per round across thousands
of jobs — grow the heap without bound), and ``n_processed`` counts executed
events for the simulator self-benchmark's events/sec metric.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Optional, Tuple

#: compact the heap when more than this many cancelled entries linger AND
#: they outnumber the live ones (amortized O(1) per cancel)
_COMPACT_MIN_CANCELLED = 64


class Simulator:
    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, "EventHandle"]] = []
        self._seq = itertools.count()
        self._stopped = False
        self._pending = 0  # live (scheduled, not cancelled, not yet run)
        self._cancelled = 0  # cancelled entries still sitting in the heap
        self.n_processed: int = 0  # lifetime count of executed events

    def schedule_at(self, t: float, fn: Callable[[], None]) -> "EventHandle":
        if t < self.now - 1e-12:
            raise ValueError(f"cannot schedule in the past: {t} < {self.now}")
        handle = EventHandle(fn, self)
        heapq.heappush(self._heap, (t, next(self._seq), handle))
        self._pending += 1
        return handle

    def schedule(self, delay: float, fn: Callable[[], None]) -> "EventHandle":
        return self.schedule_at(self.now + max(delay, 0.0), fn)

    def run(self, until: Optional[float] = None) -> None:
        self._stopped = False
        heap = self._heap
        while heap and not self._stopped:
            t, _, handle = heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(heap)
            if handle.cancelled:
                self._cancelled -= 1
                continue
            handle._live = False
            self._pending -= 1
            self.now = t
            self.n_processed += 1
            handle.fn()
        if until is not None and self.now < until and not self._stopped:
            self.now = until

    def stop(self) -> None:
        self._stopped = True

    @property
    def pending(self) -> int:
        """Live scheduled events — an O(1) counter maintained on schedule,
        cancel and pop (formerly a full heap scan)."""
        return self._pending

    # ---- lazy-deletion bookkeeping (called by EventHandle.cancel) ----------
    def _note_cancel(self) -> None:
        self._pending -= 1
        self._cancelled += 1
        if (self._cancelled > _COMPACT_MIN_CANCELLED
                and self._cancelled * 2 > len(self._heap)):
            self._compact()

    def _compact(self) -> None:
        """Drop cancelled entries and re-heapify (cancel-heavy workloads)."""
        self._heap = [e for e in self._heap if not e[2].cancelled]
        heapq.heapify(self._heap)
        self._cancelled = 0


class EventHandle:
    __slots__ = ("fn", "cancelled", "_sim", "_live")

    def __init__(self, fn: Callable[[], None],
                 sim: Optional[Simulator] = None):
        self.fn = fn
        self.cancelled = False
        self._sim = sim
        self._live = True  # still in the heap and runnable

    def cancel(self) -> None:
        if not self._live:
            # already executed, compacted away, or cancelled twice — keep
            # the flag idempotent without corrupting the pending counter
            self.cancelled = True
            return
        self.cancelled = True
        self._live = False
        if self._sim is not None:
            self._sim._note_cancel()

    # heapq tie-breaking never reaches the handle (seq is unique)
    def __lt__(self, other):  # pragma: no cover
        return id(self) < id(other)
