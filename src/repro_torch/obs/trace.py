"""``repro.obs.trace`` — sim-time structured tracing.

The tracer records what the simulated system *did* — task lifecycle,
preemptions, pool resizes, round open/close, drain triggers, calibration
updates, admission and autoscale decisions — as **sim-time** events and
spans: deterministic, no wall clock, so two runs of the same seed produce
byte-identical traces.

Two record kinds share one monotonically increasing sequence counter:

  * ``TraceEvent`` — an instant at one sim time (``t``);
  * ``Span`` — an interval ``[t0, t1]``. Container spans (``cat ==
    "container"``) are emitted at the exact moment the cluster *bills*
    them, with the exact billed endpoints, for all three billing paths
    (pooled tasks via ``Cluster._bill``, the always-on baseline via
    ``AlwaysOnContainer.shutdown``, streaming containers via
    ``RoundEngine.stream_release``) — so per-job span totals reconcile
    with the billed ``container_seconds_by_job`` ledger *exactly*, and
    the trace doubles as a billing correctness oracle (``reconcile``).

**Canonical event order at equal sim times** (the
``Cluster.occupancy_events`` vs span-stream ordering fix): the canonical
total order of the trace stream is ``(timestamp, seq)`` — emission
(simulator-execution) order at equal timestamps, with future-stamped
records (a §5.5 preemption releases its container at ``now +
checkpoint_s``) ordered at their *effective* time rather than their
emission time. ``canonical_events()`` and ``occupancy_deltas()`` return
that order; ``Cluster.occupancy_events`` merges same-timestamp deltas and
may append future-stamped releases out of time order, so consumers that
need an ordered stream should read the trace. The two integrate to
identical busy container-seconds (regression-locked in
``tests/test_obs.py``).

**Zero overhead when disabled**: the default tracer everywhere is the
module-level ``NULL_TRACER`` singleton with ``enabled = False``.
Instrumented call sites are *guarded* — ``if tracer.enabled:
tracer.event(...)`` — so the disabled hot path is one attribute read and
a branch: no call, no allocation per event (locked by
``tests/test_obs.py``).

**Wall clock** (``Tracer(clock="wall")``): the program's own spans on the
card's hot path (the queue and the aggregator), stamped with integer
``time.time_ns()`` — the clock ``torch.profiler``'s ``start_ns()`` reads,
so a span and a device trace of the same stretch line up. A span is
opened (``open``, which takes its id) and closed (``close``, which adds
its attributes); it carries its job and round, shared by every span of
one round, its parent's id, and, if asked, the device time between two
CUDA events recorded on the current stream at open and close, read only
when the trace is read. A tracer keeps one clock: sim-time records on a
wall-clock tracer, and wall-clock spans on a sim-time one, raise.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "TraceEvent",
    "Tracer",
    "wall_clock",
]


class TraceEvent(NamedTuple):
    """One instant event at sim time ``t`` (canonical order: ``(t, seq)``).

    A NamedTuple, not a dataclass: the tracer constructs one per emitted
    event on the simulator hot path, and tuple construction is what keeps
    trace-on overhead under the ``benchmarks/simcore.py`` ceiling. Treat
    records (including ``args``) as read-only.
    """

    seq: int
    t: float
    cat: str  # "cluster" | "scheduler" | "engine" | "online" | "calibration"
    name: str
    job_id: Optional[str] = None
    args: Dict[str, object] = {}


class Span(NamedTuple):
    """One interval ``[t0, t1]``. ``cat == "container"`` spans carry the
    billed endpoints of one container's life (or one task execution
    segment on the pool) and sum to the billed ledger per job."""

    seq: int  # a wall-clock span's id, taken when it opened
    t0: float  # sim seconds; ns of ``time.time_ns()`` on a wall clock
    t1: float
    cat: str
    name: str  # "task" | "always_on" | "stream"; "fold" (cat "agg") ...
    job_id: Optional[str] = None
    container_id: Optional[int] = None
    args: Dict[str, object] = {}
    round_idx: Optional[int] = None  # wall clock only, as the three below
    parent: Optional[int] = None
    device_s: Optional[float] = None  # between the span's CUDA events

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class NullTracer:
    """The disabled tracer: ``enabled`` is False and every method is a
    no-op. The module-level ``NULL_TRACER`` singleton is the default
    everywhere; instrumented code must *guard* on ``enabled`` rather than
    call these (the guard discipline is what makes the disabled hot path
    allocation-free, and is locked by a test that makes these raise)."""

    enabled = False

    def event(self, t, cat, name, job_id=None, **args) -> None:
        pass

    def span(self, t0, t1, cat, name, job_id=None, container_id=None,
             **args) -> None:
        pass

    def open(self, cat, name, job_id=None, round_idx=None, parent=None,
             device=False) -> None:
        pass

    def close(self, sid, **args) -> None:
        pass


#: THE disabled tracer. One instance, shared by every component that was
#: not handed an explicit ``Tracer`` — identity-checked in tests.
NULL_TRACER = NullTracer()

#: synthetic container ids for spans whose container lives outside the
#: cluster's pool id space (always-on / streaming containers) — kept far
#: above any realistic pooled id so tracks never collide
_SYNTH_CID_BASE = 1_000_000

CLOCKS = ("sim", "wall")


def wall_clock(tracer):
    """``tracer``, refused if it records on the sim clock: the card's hot
    path (queue, aggregator) stamps wall-clock spans only."""
    if tracer.enabled and tracer.clock != "wall":
        raise ValueError(f"the queue and the aggregator record wall-clock "
                         f"spans; this tracer's clock is {tracer.clock!r}")
    return tracer


def _read_span(raw: tuple) -> Span:
    """The ``Span`` of a raw record; a wall-clock span's CUDA events, if
    it has them, are read here (both must have completed)."""
    if len(raw) == 8:
        return Span(*raw)
    ev = raw[10]
    return Span(*raw[:10], ev[0].elapsed_time(ev[1]) * 1e-3 if ev else None)


class Tracer:
    """Recording tracer: sim-time events + spans + a metrics registry.

    ``max_events`` bounds the instant-event list (drop-oldest) for
    long-horizon traces; spans are one per billed container segment and
    stay unbounded (they are the reconciliation ledger).

    ``clock`` is ``"sim"`` (the simulator's events and spans, the
    default) or ``"wall"`` (``open`` / ``close`` spans in ns of
    ``time.time_ns()``, from one thread; ``take_spans`` reads them round
    by round).
    """

    enabled = True

    def __init__(self, max_events: Optional[int] = None, *,
                 clock: str = "sim"):
        if clock not in CLOCKS:
            raise ValueError(f"clock {clock!r} is not one of {CLOCKS}")
        self.clock = clock
        self._wall = clock == "wall"
        #: open wall-clock spans: id -> (cat, name, job_id, round_idx,
        #: parent, start CUDA event, t0)
        self._open: Dict[int, tuple] = {}
        self._seq = 0
        self.max_events = max_events
        #: raw record storage: plain tuples in TraceEvent/Span field order
        #: (materialized into NamedTuples lazily by the ``events``/``spans``
        #: properties — the cold read path pays, not the hot emit path)
        self._events: List[tuple] = []
        self._spans: List[tuple] = []
        self._events_view: Optional[List[TraceEvent]] = None
        self._events_view_seq = -1
        self._spans_view: Optional[List[Span]] = None
        self._spans_view_seq = -1
        self.metrics = MetricsRegistry()
        self._synth_cid = _SYNTH_CID_BASE
        self.n_dropped_events = 0
        self._dropped_counts: Dict[str, int] = {}

    # ---- recording -------------------------------------------------------
    # Both emitters run on the simulator hot path when tracing is on, so
    # they stay lean: one plain tuple and one list append per record.
    # NamedTuple views, per-event counters and the container-span
    # histogram are all derived lazily on read — which is what keeps
    # trace-on overhead under the ``benchmarks/simcore.py`` ceiling.
    def event(self, t: float, cat: str, name: str,
              job_id: Optional[str] = None, **args) -> None:
        if self._wall:
            raise ValueError("a wall-clock tracer records no sim-time event")
        self._seq = seq = self._seq + 1
        events = self._events
        events.append((seq, t, cat, name, job_id, args))
        if self.max_events is not None and len(events) > self.max_events:
            ev = events.pop(0)
            key = ev[2] + "." + ev[3]
            self._dropped_counts[key] = self._dropped_counts.get(key, 0) + 1
            self.n_dropped_events += 1

    def span(self, t0: float, t1: float, cat: str, name: str,
             job_id: Optional[str] = None,
             container_id: Optional[int] = None, **args) -> None:
        if self._wall:
            raise ValueError("a wall-clock tracer records no sim-time span")
        if container_id is None and cat == "container":
            self._synth_cid = container_id = self._synth_cid + 1
        self._seq = seq = self._seq + 1
        self._spans.append((seq, t0, t1, cat, name, job_id, container_id,
                            args))

    # ---- wall clock --------------------------------------------------------
    # One span a message on the aggregator's hot path: a clock read, a
    # tuple and a dict entry at open, a clock read and a list append at
    # close; the CUDA events are read only by ``take_spans`` / ``spans``.
    def open(self, cat: str, name: str, job_id: Optional[str] = None,
             round_idx: Optional[int] = None, parent: Optional[int] = None,
             device: bool = False) -> int:
        """Open a wall-clock span and return its id. A span under a
        ``parent`` takes the parent's job and round where it names none.
        ``device``: record a CUDA event on the current stream now and at
        ``close``."""
        if not self._wall:
            raise ValueError("a sim-time tracer records no wall-clock span")
        if parent is not None:
            p = self._open[parent]
            job_id = p[2] if job_id is None else job_id
            round_idx = p[3] if round_idx is None else round_idx
        ev = None
        if device:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._seq = sid = self._seq + 1
        self._open[sid] = (cat, name, job_id, round_idx, parent, ev,
                           time.time_ns())
        return sid

    def start_ns(self, sid: int) -> int:
        """The ``time.time_ns()`` at which open span ``sid`` opened."""
        return self._open[sid][6]

    def close(self, sid: int, **args) -> None:
        """Close open span ``sid``; ``args`` are its attributes."""
        t1 = time.time_ns()
        cat, name, job_id, round_idx, parent, ev0, t0 = self._open.pop(sid)
        ev = None
        if ev0 is not None:
            import torch

            ev = (ev0, torch.cuda.Event(enable_timing=True))
            ev[1].record()
        self._spans.append((sid, t0, t1, cat, name, job_id, None, args,
                            round_idx, parent, ev))

    def take_spans(self) -> List[Span]:
        """The spans closed since the last call, in closing order, read
        (CUDA events too: synchronise first) and dropped from the tracer,
        so a long run reads its spans round by round in bounded memory."""
        raw, self._spans = self._spans, []
        self._spans_view = None
        return [_read_span(s) for s in raw]

    # ---- materialized views ----------------------------------------------
    @property
    def events(self) -> List[TraceEvent]:
        """The instant events in emission order, as ``TraceEvent`` records
        (materialized from raw storage on first read after new emissions)."""
        if self._events_view is None or self._events_view_seq != self._seq:
            make = TraceEvent._make
            self._events_view = [make(e) for e in self._events]
            self._events_view_seq = self._seq
        return self._events_view

    @property
    def spans(self) -> List[Span]:
        """The spans in emission order, as ``Span`` records."""
        if self._spans_view is None or self._spans_view_seq != self._seq:
            self._spans_view = [_read_span(s) for s in self._spans]
            self._spans_view_seq = self._seq
        return self._spans_view

    # ---- metrics ---------------------------------------------------------
    def _materialize_metrics(self) -> None:
        """Rebuild the derived metrics — per-record ``{cat}.{name}``
        counters (including drop-aged events) and the ``container.span_s``
        histogram — from the recorded stream. Idempotent; counters whose
        names the tracer derives are owned by this method, while metrics
        other components register directly (e.g. the scheduler's
        ``round_lateness_s``) are left untouched."""
        counts: Dict[str, int] = dict(self._dropped_counts)
        for ev in self.events:
            key = ev.cat + "." + ev.name
            counts[key] = counts.get(key, 0) + 1
        span_s: List[float] = []
        for s in self.spans:
            key = s.cat + "." + s.name
            counts[key] = counts.get(key, 0) + 1
            if s.cat == "container":
                span_s.append(s.t1 - s.t0)
        for key, n in counts.items():
            self.metrics.counter(key).n = n
        self.metrics.histogram("container.span_s").samples = span_s

    def snapshot(self, t: Optional[float] = None) -> Dict[str, object]:
        """A metrics snapshot at sim time ``t``: materializes the derived
        counters/histograms, then returns ``MetricsRegistry.snapshot``."""
        self._materialize_metrics()
        return self.metrics.snapshot(t)

    # ---- canonical views -------------------------------------------------
    def canonical_events(self) -> List[TraceEvent]:
        """The instant-event stream in the canonical ``(t, seq)`` total
        order: emission order at equal sim times, future-stamped records
        at their effective time. This IS the defined event order at equal
        timestamps — regression-locked in ``tests/test_obs.py``."""
        return sorted(self.events, key=lambda e: (e.t, e.seq))

    def occupancy_deltas(self) -> List[Tuple[float, int]]:
        """Container up/down deltas reconstructed from container spans in
        canonical ``(t, seq)`` order — a time-sorted alternative to
        ``Cluster.occupancy_events`` (which merges same-timestamp deltas
        and may hold future-stamped preemption releases out of order);
        both integrate to identical busy container-seconds."""
        deltas: List[Tuple[float, int, int]] = []
        for s in self.spans:
            if s.cat != "container":
                continue
            deltas.append((s.t0, s.seq, +1))
            deltas.append((s.t1, s.seq, -1))
        deltas.sort(key=lambda d: (d[0], d[1]))
        return [(t, d) for t, _, d in deltas]

    def tail_by_job(self, n: int = 20) -> Dict[str, List[Dict[str, object]]]:
        """The last ``n`` events per job (canonical order), as plain dicts
        — the excerpt a failed conformance cell attaches to its report so
        a nightly failure is diagnosable from the artifact alone."""
        out: Dict[str, List[Dict[str, object]]] = {}
        for ev in reversed(self.canonical_events()):
            if ev.job_id is None:
                continue
            bucket = out.setdefault(ev.job_id, [])
            if len(bucket) < n:
                bucket.append({"t": ev.t, "cat": ev.cat, "name": ev.name,
                               **ev.args})
        for bucket in out.values():
            bucket.reverse()
        return out

    # ---- reconciliation (the billing oracle) -----------------------------
    def container_seconds_by_job(self) -> Dict[str, float]:
        """Per-job busy container-seconds recomputed from spans, summed in
        emission order — the same order (and the same float values) the
        cluster's billed ledger accumulated, so a clean run reconciles
        exactly."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.cat != "container" or s.job_id is None:
                continue
            out[s.job_id] = out.get(s.job_id, 0.0) + (s.t1 - s.t0)
        return out

    def preemptions_by_job(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            if ev.cat == "cluster" and ev.name == "preempt" \
                    and ev.job_id is not None:
                out[ev.job_id] = out.get(ev.job_id, 0) + 1
        return out

    def reconcile(self, cluster, *, rel_tol: float = 1e-9,
                  abs_tol: float = 1e-6) -> List[str]:
        """Check span-derived container-seconds against the cluster's
        billed per-job ledger (and preempt events against the preemption
        ledger). Returns human-readable mismatches; empty == reconciled.
        Valid at any sim time: both sides account only *billed* (released)
        container time, never accrued-but-live time."""
        import math

        failures: List[str] = []
        traced = self.container_seconds_by_job()
        billed = cluster.container_seconds_by_job
        for job_id in sorted(set(traced) | set(billed)):
            a, b = traced.get(job_id, 0.0), billed.get(job_id, 0.0)
            if not math.isclose(a, b, rel_tol=rel_tol, abs_tol=abs_tol):
                failures.append(
                    f"job {job_id!r}: traced {a!r} != billed {b!r} "
                    f"container-seconds")
        tp = self.preemptions_by_job()
        bp = cluster.n_preemptions_by_job
        for job_id in sorted(set(tp) | set(bp)):
            a, b = tp.get(job_id, 0), bp.get(job_id, 0)
            if a != b:
                failures.append(
                    f"job {job_id!r}: {a} traced preempt events != "
                    f"{b} ledger preemptions")
        return failures

    # ---- Chrome-trace / Perfetto export ----------------------------------
    def export_chrome(self, path: str, *,
                      time_unit_us: Optional[float] = None) -> int:
        """Write the trace as Chrome Trace Event Format JSON (loadable in
        Perfetto / ``chrome://tracing``): one track per container (pid 1),
        one per job (pid 2), a control track (pid 3) with pool-capacity
        counters, instant events for preemptions and resizes. Sim seconds
        map to trace microseconds; a wall-clock tracer's spans go on the
        job tracks at ``ts`` in us of ``time.time_ns()``, with their id,
        parent, round and device seconds. Returns the number of trace
        events written."""
        if time_unit_us is None:
            time_unit_us = 1e-3 if self._wall else 1e6
        tevs: List[Dict[str, object]] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "containers"}},
            {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
             "args": {"name": "jobs"}},
            {"ph": "M", "pid": 3, "tid": 0, "name": "process_name",
             "args": {"name": "control"}},
        ]
        job_tid: Dict[str, int] = {}

        def tid_of(job_id: Optional[str]) -> int:
            if job_id is None:
                return 0
            tid = job_tid.get(job_id)
            if tid is None:
                tid = job_tid[job_id] = len(job_tid) + 1
                tevs.append({"ph": "M", "pid": 2, "tid": tid,
                             "name": "thread_name",
                             "args": {"name": job_id}})
            return tid

        for s in self.spans:
            if s.cat == "container":
                pid, tid = 1, s.container_id or 0
                name = f"{s.name}:{s.job_id}" if s.job_id else s.name
            else:
                pid, tid = 2, tid_of(s.job_id)
                name = s.name
            args = {"job": s.job_id, **s.args}
            if self._wall:
                args.update(id=s.seq, parent=s.parent, round=s.round_idx,
                            device_s=s.device_s)
            tevs.append({
                "ph": "X", "pid": pid, "tid": tid, "name": name,
                "cat": s.cat, "ts": s.t0 * time_unit_us,
                "dur": max(s.t1 - s.t0, 0.0) * time_unit_us,
                "args": args,
            })
        for ev in self.canonical_events():
            ts = ev.t * time_unit_us
            if ev.cat == "cluster" and ev.name == "preempt":
                tevs.append({
                    "ph": "i", "s": "p", "pid": 1,
                    "tid": ev.args.get("container", 0) or 0,
                    "name": "preempt", "cat": ev.cat, "ts": ts,
                    "args": {"job": ev.job_id, **ev.args}})
                continue
            if ev.cat == "cluster" and ev.name == "pool_resize":
                tevs.append({"ph": "i", "s": "g", "pid": 3, "tid": 0,
                             "name": "pool_resize", "cat": ev.cat,
                             "ts": ts, "args": dict(ev.args)})
                tevs.append({"ph": "C", "pid": 3, "tid": 0,
                             "name": "pool_capacity", "ts": ts,
                             "args": {"capacity": ev.args.get("capacity")}})
                continue
            tevs.append({
                "ph": "i", "s": "t", "pid": 2, "tid": tid_of(ev.job_id),
                "name": ev.name, "cat": ev.cat, "ts": ts,
                "args": {"job": ev.job_id, **ev.args}})
        with open(path, "w") as f:
            json.dump({"traceEvents": tevs, "displayTimeUnit": "ms"}, f)
        return len(tevs)
