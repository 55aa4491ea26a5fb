"""``OnlineController`` — the Platform as a long-lived service.

Owns one arrival-gated ``JITScheduler`` + ``Cluster`` (through an
incrementally-fed ``FleetRunner``, so every baseline strategy runs over
the same machinery) and consumes an ``ArrivalStream`` open-loop:

  * **admission control** with priority SLA classes. Under burst —
    strictly more than ``AdmissionConfig.burst_arrivals`` front-door
    arrivals inside the trailing ``burst_window_s`` — ``gold`` jobs are
    still admitted immediately, ``silver``/``best_effort`` jobs queue, and
    ``best_effort`` jobs are shed once the queue is full (best_effort
    never queues ahead of silver: it sheds directly under burst when
    ``shed_under_burst``). Queued jobs are released at control ticks once
    the burst clears, in SLA-class order (rank, then FIFO within a
    class). Decisions depend ONLY on the arrival clock — never on
    downstream completion — so two strategies fed the same stream
    admit/queue/shed the identical job multiset at identical times and
    paired cost comparisons stay paired.
  * **pool priorities**: every admitted job's pool tasks carry its class
    ``rank``, making shared-cluster task priority (rank, deadline) —
    gold drains preempt running best_effort drains under §5.5
    preemption-by-checkpoint, so gold holds its lateness band even when
    the pool itself saturates and admission control alone cannot help.
  * **autoscaling** of the aggregator pool against observed queue depth
    (``len(cluster.pending)``), the scheduler's class-weighted drain
    backlog (``backlog_weight``: queued gold counts more than queued
    best_effort) and the trailing mean occupancy integrated from
    ``Cluster.occupancy_events`` against the capacity in effect at each
    event time: scale up ``scale_up_step`` when queued work piles up,
    scale down ``scale_down_step`` only after ``scale_down_ticks``
    consecutive low-occupancy ticks (hysteresis, on the raw backlog),
    within ``[min_capacity, max_capacity]``.
  * **windowed metrics** (``WindowedFleetMetrics``) pollable mid-run via
    ``poll()``, reconciling against the batch ``fleet_rollup`` at the end.

Per-class lateness reuses ``core.metrics.sla_lateness`` — the samples ARE
the per-round lateness the underlying vehicle records; the controller
attributes them to SLA classes as rounds complete.

Drive it with ``advance(until=...)`` (repeatable; poll between calls) or
``drain()`` (runs to quiescence; requires the stream to be closed — with
an open ``StreamHandle`` the service is live forever by design, so an
unbounded ``sim.run()`` would never return).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import math
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple, Union

import collections

from repro_torch.core.cluster import Cluster
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import EventHandle, Simulator
from repro_torch.core.metrics import FleetMetrics, JobMetrics, percentile
from repro_torch.fleet.fleet import FleetRunner
from repro_torch.fleet.traces import JobTrace, WorkloadTrace
from repro_torch.obs.dashboard import DashboardView
from repro_torch.online.stream import ArrivalStream
from repro_torch.online.window import WindowedFleetMetrics, WindowStats


# --------------------------------------------------------------------------
# SLA classes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLAClass:
    """One admission-priority class and its declared lateness band."""

    name: str
    #: declared §5.5 SLA: pooled p95 round lateness must stay below this
    #: (math.inf = no lateness promise)
    lateness_p95_band_s: float
    #: under burst: wait in the admission queue instead of starting now
    queue_under_burst: bool
    #: under burst: drop the job outright (never runs, never billed)
    shed_under_burst: bool
    #: pool-priority rank (0 = most important). Every pool task an admitted
    #: job submits carries it: effective task priority on the shared
    #: cluster is (rank, deadline), so gold drains preempt running
    #: best_effort drains under §5.5 preemption-by-checkpoint, and the
    #: admission queue releases in rank order. Rank 0 everywhere (the
    #: single-class default) is today's pure-deadline scheduling.
    rank: int = 0
    #: scale-up pressure per queued gated update of this class: the
    #: autoscaler compares sum(backlog_j * weight_class(j)) against
    #: ``scale_up_backlog``, so queued gold work grows the pool sooner
    #: than the same volume of best_effort work. 1.0 keeps the all-gold
    #: default identical to the unweighted signal.
    backlog_weight: float = 1.0


#: The default class ladder. ``gold`` always admits; ``silver`` queues
#: under burst but is never shed; ``best_effort`` is shed under burst.
SLA_CLASSES: Dict[str, SLAClass] = {
    "gold": SLAClass("gold", lateness_p95_band_s=60.0,
                     queue_under_burst=False, shed_under_burst=False,
                     rank=0, backlog_weight=1.0),
    "silver": SLAClass("silver", lateness_p95_band_s=600.0,
                       queue_under_burst=True, shed_under_burst=False,
                       rank=1, backlog_weight=0.5),
    "best_effort": SLAClass("best_effort",
                            lateness_p95_band_s=math.inf,
                            queue_under_burst=True, shed_under_burst=True,
                            rank=2, backlog_weight=0.25),
}

#: job -> class assignment accepted by ``Platform.serve(sla=...)``
SlaSpec = Union[None, str, Dict[str, str], Callable[[JobTrace, int], str]]


def _make_classifier(sla: SlaSpec) -> Callable[[JobTrace, int], str]:
    if sla is None:
        return lambda jt, i: "gold"
    if isinstance(sla, str):
        return lambda jt, i, _name=sla: _name
    if isinstance(sla, dict):
        def lookup(jt: JobTrace, i: int, _m=dict(sla)) -> str:
            try:
                return _m[jt.job_id]
            except KeyError:
                raise KeyError(
                    f"sla mapping has no class for job {jt.job_id!r}; "
                    f"map every job id or pass a callable") from None
        return lookup
    if callable(sla):
        return sla
    raise TypeError(
        f"sla must be None, a class name, a job_id->class dict or a "
        f"callable (job_trace, arrival_index) -> class; got {type(sla)}")


# --------------------------------------------------------------------------
# knobs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Burst detection + queue sizing. Burst is a FRONT-DOOR rate signal
    (arrivals in the trailing window), deliberately independent of the
    deployment strategy under test so shed/queue decisions pair up across
    strategy comparisons."""

    burst_window_s: float = 300.0
    #: strictly more arrivals than this inside the window = burst
    burst_arrivals: int = 6
    #: silver/best_effort queue capacity; overflow is shed
    queue_limit: int = 64
    #: queued jobs released per control tick once the burst clears
    dequeue_per_tick: int = 4

    def __post_init__(self):
        if self.burst_window_s <= 0.0:
            raise ValueError("burst_window_s must be > 0")
        if self.burst_arrivals < 1:
            raise ValueError("burst_arrivals must be >= 1")
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        if self.dequeue_per_tick < 1:
            raise ValueError("dequeue_per_tick must be >= 1")


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Aggregator-pool autoscaling with scale-up/scale-down hysteresis."""

    min_capacity: int = 1
    #: None: 4x the cluster's initial capacity
    max_capacity: Optional[int] = None
    control_interval_s: float = 30.0
    #: scale up when this many pool tasks are queued ...
    scale_up_pending: int = 2
    #: ... or this many gated updates await a drain (scheduler vehicle)
    scale_up_backlog: int = 32
    scale_up_step: int = 2
    #: scale down after scale_down_ticks consecutive ticks with trailing
    #: mean occupancy <= scale_down_occupancy and nothing queued
    scale_down_occupancy: float = 0.5
    scale_down_ticks: int = 3
    scale_down_step: int = 1

    def __post_init__(self):
        if self.min_capacity < 1:
            raise ValueError("min_capacity must be >= 1")
        if self.max_capacity is not None and \
                self.max_capacity < self.min_capacity:
            raise ValueError("max_capacity must be >= min_capacity")
        if self.control_interval_s <= 0.0:
            raise ValueError("control_interval_s must be > 0")
        if self.scale_up_step < 1 or self.scale_down_step < 1:
            raise ValueError("scale steps must be >= 1")
        if self.scale_down_ticks < 1:
            raise ValueError("scale_down_ticks must be >= 1")
        if not 0.0 <= self.scale_down_occupancy <= 1.0:
            raise ValueError("scale_down_occupancy must be in [0, 1]")

    @classmethod
    def fixed(cls, capacity: int, **kw) -> "AutoscalerConfig":
        """A pinned pool: min == max == capacity (autoscaling disabled)."""
        return cls(min_capacity=capacity, max_capacity=capacity, **kw)


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ClassStats:
    """Per-SLA-class admission + lateness accounting."""

    name: str
    arrived: int = 0
    admitted: int = 0
    queued: int = 0  # of the admitted, how many waited in the queue
    shed: int = 0
    #: §5.5 preemptions suffered by this class's jobs on the shared pool —
    #: under class-rank scheduling, best_effort absorbs the evictions that
    #: keep gold inside its lateness band
    preemptions: int = 0
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    lateness: List[float] = dataclasses.field(default_factory=list)

    @property
    def p95_lateness_s(self) -> Optional[float]:
        return percentile(self.lateness, 0.95) if self.lateness else None

    def summary(self) -> Dict[str, object]:
        p95 = self.p95_lateness_s
        return {
            "class": self.name,
            "arrived": self.arrived,
            "admitted": self.admitted,
            "queued": self.queued,
            "shed": self.shed,
            "preemptions": self.preemptions,
            "p95_lateness_s": None if p95 is None else round(p95, 3),
            "max_queue_wait_s": (round(max(self.queue_wait_s), 3)
                                 if self.queue_wait_s else 0.0),
        }


@dataclasses.dataclass
class OnlineReport:
    """End-of-service report: batch-compatible per-job/fleet metrics plus
    the online-only views (windows, per-class SLA, pool timeline)."""

    strategy: str
    jobs: Dict[str, JobMetrics]
    fleet: FleetMetrics
    windows: List[WindowStats]
    rollup: Dict[str, object]
    classes: Dict[str, ClassStats]
    shed_jobs: List[str]
    pool_timeline: List[Tuple[float, int]]  # (t, capacity) steps
    #: integral of pool capacity over the service lifetime — what a
    #: provisioned (reserved) pool of that size would have billed
    pool_container_seconds: float
    peak_pool: int

    def sla_attainment(
        self, sla_classes: Dict[str, SLAClass] = None,
    ) -> Dict[str, Dict[str, object]]:
        """Observed per-class p95 lateness vs the declared band."""
        bands = sla_classes or SLA_CLASSES
        out: Dict[str, Dict[str, object]] = {}
        for name, st in self.classes.items():
            band = bands[name].lateness_p95_band_s if name in bands \
                else math.inf
            p95 = st.p95_lateness_s
            out[name] = {
                "p95_lateness_s": p95,
                "band_s": band,
                "attained": (True if p95 is None
                             else p95 <= band),
                "shed": st.shed,
                "admitted": st.admitted,
            }
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "strategy": self.strategy,
            "n_jobs": self.fleet.n_jobs,
            "rounds": self.fleet.rounds_done,
            "makespan_s": round(self.fleet.makespan_s, 1),
            "container_seconds": round(self.fleet.container_seconds, 1),
            "cost_usd": round(self.fleet.cost_usd, 4),
            "pool_container_seconds": round(self.pool_container_seconds, 1),
            "peak_pool": self.peak_pool,
            "windows": len(self.windows),
            "shed": len(self.shed_jobs),
            "classes": {n: s.summary() for n, s in sorted(
                self.classes.items())},
        }


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------
class OnlineController:
    """One long-lived online service over a platform's sim/cluster.

    Construct via ``Platform.serve(stream, ...)``. The controller starts
    itself: the first control tick, the first window boundary and the
    first stream pull are scheduled at construction; driving the
    simulator (``advance``/``drain``/``Platform.run``) runs the service.
    """

    def __init__(
        self,
        sim: Simulator,
        cluster: Cluster,
        estimator: AggregationEstimator,
        stream: ArrivalStream,
        *,
        strategy: str = "jit",
        sla: SlaSpec = None,
        sla_classes: Optional[Dict[str, SLAClass]] = None,
        autoscaler: Optional[AutoscalerConfig] = None,
        admission: Optional[AdmissionConfig] = None,
        window_s: float = 600.0,
        seed: int = 0,
        round_gap_s: float = 1.0,
        priority_policy: str = "deadline",
        recorder=None,
        on_admitted: Optional[Callable[[str], None]] = None,
    ):
        self.sim = sim
        self.cluster = cluster
        # sim-time tracer (repro.obs) — shared with the cluster, emission
        # guarded on ``enabled`` (free when disabled). Set it before the
        # controller is built (``Platform.serve(trace=...)``).
        self.tracer = cluster.tracer
        self.stream = stream
        self.auto = autoscaler or AutoscalerConfig()
        self.adm = admission or AdmissionConfig()
        self.sla_classes = dict(sla_classes or SLA_CLASSES)
        self._classify = _make_classifier(sla)
        self._on_admitted = on_admitted
        self.runner = FleetRunner(
            sim, cluster, estimator,
            WorkloadTrace(name="online"),  # fed via submit_job
            strategy=strategy, seed=seed, round_gap_s=round_gap_s,
            priority_policy=priority_policy, recorder=recorder,
            on_round=self._on_round, on_job_complete=self._on_job_complete,
        )
        self.strategy_name = self.runner.strategy_name
        # ---- pool state -------------------------------------------------
        self._max_capacity = (self.auto.max_capacity
                              if self.auto.max_capacity is not None
                              else 4 * cluster.cfg.capacity)
        start_cap = min(max(cluster.capacity, self.auto.min_capacity),
                        self._max_capacity)
        if start_cap != cluster.capacity:
            cluster.resize(start_cap)
        self.pool_timeline: List[Tuple[float, int]] = [(sim.now, start_cap)]
        self._idle_ticks = 0
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        # occupancy integrator over Cluster.occupancy_events
        self._occ_idx = 0
        self._occ_level = 0
        self._occ_prev_t = sim.now
        # ---- admission state ---------------------------------------------
        self._arrivals: Deque[float] = collections.deque()  # trailing times
        # class-ordered admission queue: a heap on (rank, seq) so a release
        # tick always admits the highest class first, FIFO within a class —
        # a queued best_effort job can never jump a later-queued silver one.
        # Entries: (rank, seq, queued_at, class_name, job_trace).
        self._queue: List[Tuple[int, int, float, str, JobTrace]] = []
        self._queue_seq = itertools.count()
        self._active: Set[str] = set()
        self._arrived_n = 0
        self.class_of: Dict[str, str] = {}
        self.stats: Dict[str, ClassStats] = {
            name: ClassStats(name) for name in self.sla_classes}
        self.shed_jobs: List[str] = []
        # per-job consumed-sample cursors into the vehicle's metric lists
        self._cursor: Dict[str, Tuple[int, int]] = {}
        # ---- windows -----------------------------------------------------
        self.windows = WindowedFleetMetrics(
            sim, window_s,
            cs_getter=self._billed_container_seconds,
            pool_getter=lambda: self.cluster.capacity,
            price_per_container_s=cluster.cfg.price_per_container_s,
            preempt_getter=self._preemptions_by_class,
        )
        self.windows.start()
        # ---- liveness ----------------------------------------------------
        self._inflight_arrival = False
        self._done = False
        self._tick_evt: Optional[EventHandle] = sim.schedule(
            self.auto.control_interval_s, self._tick)
        stream.bind_waker(self._wake)
        self._pull_next()

    # ---- driving --------------------------------------------------------
    def advance(self, until: float) -> "OnlineController":
        """Run the service up to virtual time ``until`` (repeatable —
        unlike batch ``Platform.run`` the online vehicle is pollable:
        advance, ``poll()``, advance again)."""
        self.sim.run(until)
        return self

    def drain(self) -> "OnlineReport":
        """Run until the service quiesces (stream exhausted, queue empty,
        every admitted job complete) and return the final report."""
        if not self.stream.will_close:
            # an open StreamHandle keeps the service (control ticks,
            # window boundaries) alive forever by design
            raise RuntimeError(
                "drain() needs a stream that ends; close() the "
                "StreamHandle first (or drive with advance(until=...))")
        self.sim.run()
        if not self._done:
            raise RuntimeError(
                "service did not quiesce: stream still open or jobs "
                "pending — drive with advance(until=...) instead")
        return self.result()

    def poll(self) -> List[WindowStats]:
        """Completed metric windows so far (mid-run safe)."""
        return self.windows.snapshot()

    def dashboard(self, last_windows: int = 5) -> DashboardView:
        """A structured live view of the service at the current sim time:
        per-class admission/backlog/preemptions, pool occupancy, and the
        trailing window summaries from ``poll()``. Mid-run safe (advance,
        ``dashboard()``, advance again); pool occupancy is instantaneous
        (running / capacity) — the autoscaler's trailing-mean integrator is
        stateful and is not consumed here."""
        now = self.sim.now
        raw, weighted = self._weighted_backlog()
        queue_by_class: Dict[str, int] = {}
        for _, _, _, name, _ in self._queue:
            queue_by_class[name] = queue_by_class.get(name, 0) + 1
        preempts = self._preemptions_by_class()
        classes: Dict[str, Dict[str, object]] = {}
        for name, st in sorted(self.stats.items()):
            view = st.summary()
            view["preemptions"] = preempts.get(name, 0)
            view["queue_depth_now"] = queue_by_class.get(name, 0)
            classes[name] = view
        running = len(self.cluster.running)
        cap = self.cluster.capacity
        admitted_total = sum(st.admitted for st in self.stats.values())
        tr = self.tracer
        return DashboardView(
            t=now,
            strategy=self.strategy_name,
            done=self._done,
            pool={
                "capacity": cap,
                "running": running,
                "pending": len(self.cluster.pending),
                "occupancy": running / cap if cap else 0.0,
                "peak": max(c for _, c in self.pool_timeline),
                "scale_ups": self.n_scale_ups,
                "scale_downs": self.n_scale_downs,
            },
            backlog={"raw": float(raw), "weighted": weighted},
            admission={
                "burst": len(self._arrivals) > self.adm.burst_arrivals,
                "window_arrivals": len(self._arrivals),
                "queue_depth": len(self._queue),
                "queue_limit": self.adm.queue_limit,
            },
            classes=classes,
            jobs={
                "arrived": self._arrived_n,
                "active": len(self._active),
                "completed": admitted_total - len(self._active),
                "shed": len(self.shed_jobs),
            },
            windows=[w.summary() for w in self.poll()[-last_windows:]],
            metrics=tr.snapshot(now) if tr.enabled else None,
        )

    @property
    def done(self) -> bool:
        return self._done

    # ---- stream consumption ----------------------------------------------
    def _wake(self, at: Optional[float]) -> None:
        """A push stream announced new work (or closed)."""
        if self._inflight_arrival:
            return  # the in-flight arrival's handler re-pulls
        if not self._pull_next():
            # nothing pulled: a bare close() notification — re-check
            self._maybe_finish()

    def _pull_next(self) -> bool:
        """Pull ONE arrival from the stream and schedule it; sequential
        pulls keep arrival times non-decreasing and the stream lazy."""
        if self._inflight_arrival or self._done:
            return False
        nxt = self.stream.next_job(self.sim.now)
        if nxt is None:
            return False
        t, jt = nxt
        self._inflight_arrival = True
        self.sim.schedule_at(max(t, self.sim.now),
                             lambda jt=jt: self._on_arrival(jt))
        return True

    def _on_arrival(self, jt: JobTrace) -> None:
        self._inflight_arrival = False
        now = self.sim.now
        idx = self._arrived_n
        self._arrived_n += 1
        self._arrivals.append(now)
        self._trim_arrivals(now)
        name = self._classify(jt, idx)
        if name not in self.sla_classes:
            raise ValueError(
                f"unknown SLA class {name!r} for job {jt.job_id!r}; "
                f"declared classes: {sorted(self.sla_classes)}")
        self.class_of[jt.job_id] = name
        cls = self.sla_classes[name]
        st = self.stats[name]
        st.arrived += 1
        burst = len(self._arrivals) > self.adm.burst_arrivals
        if burst and cls.shed_under_burst:
            self._shed(jt, st, reason="burst")
        elif burst and cls.queue_under_burst:
            if len(self._queue) >= self.adm.queue_limit:
                self._shed(jt, st, reason="queue_full")
            else:
                heapq.heappush(self._queue, (cls.rank, next(self._queue_seq),
                                             now, name, jt))
                self.windows.observe_admission("queued")
                tr = self.tracer
                if tr.enabled:
                    tr.event(now, "online", "queue", jt.job_id, cls=name,
                             burst=burst,
                             window_arrivals=len(self._arrivals),
                             queue_depth=len(self._queue))
        else:
            self._admit(jt, st)
        self._pull_next()
        self._maybe_finish()

    def _trim_arrivals(self, now: float) -> None:
        cutoff = now - self.adm.burst_window_s
        while self._arrivals and self._arrivals[0] <= cutoff:
            self._arrivals.popleft()

    def _shed(self, jt: JobTrace, st: ClassStats,
              reason: str = "burst") -> None:
        st.shed += 1
        self.shed_jobs.append(jt.job_id)
        self.windows.observe_admission("shed")
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "online", "shed", jt.job_id,
                     cls=st.name, reason=reason,
                     window_arrivals=len(self._arrivals),
                     queue_depth=len(self._queue))

    def _admit(self, jt: JobTrace, st: ClassStats,
               queued_since: Optional[float] = None) -> None:
        # the job's class rank rides on every pool task it submits, making
        # shared-cluster task priority (rank, deadline) — §5.5 priorities
        # across admission classes, not just at the front door
        self.runner.submit_job(jt, class_rank=self.sla_classes[st.name].rank)
        self._active.add(jt.job_id)
        self._cursor[jt.job_id] = (0, 0)
        st.admitted += 1
        if queued_since is not None:
            st.queued += 1
            st.queue_wait_s.append(self.sim.now - queued_since)
        self.windows.observe_admission("admitted")
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "online", "admit", jt.job_id,
                     cls=st.name, queued=queued_since is not None,
                     queue_wait_s=(self.sim.now - queued_since
                                   if queued_since is not None else 0.0),
                     window_arrivals=len(self._arrivals))
        if self._on_admitted is not None:
            self._on_admitted(jt.job_id)

    # ---- vehicle hooks ----------------------------------------------------
    def _job_samples(self, job_id: str) -> Tuple[List[float], List[float]]:
        if self.runner.use_scheduler:
            st = self.runner.scheduler.jobs[job_id]
            return st.latencies, st.lateness
        m = self.runner.engines[job_id].metrics
        return m.round_latencies, m.round_lateness

    def _consume_samples(self, job_id: str) -> None:
        lats, lates = self._job_samples(job_id)
        li, gi = self._cursor[job_id]
        new_lat, new_late = lats[li:], lates[gi:]
        self._cursor[job_id] = (len(lats), len(lates))
        name = self.class_of[job_id]
        self.windows.observe_round(name, new_lat, new_late)
        if new_late:
            self.stats[name].lateness.extend(new_late)

    def _on_round(self, job_id: str, round_idx: int, t: float) -> None:
        self._consume_samples(job_id)

    def _on_job_complete(self, job_id: str) -> None:
        # tail sweep: any samples appended without a round hook (none in
        # the current vehicles, but cursors make the invariant robust)
        lats, lates = self._job_samples(job_id)
        li, gi = self._cursor[job_id]
        if li < len(lats) or gi < len(lates):
            name = self.class_of[job_id]
            self._cursor[job_id] = (len(lats), len(lates))
            self.windows._cur.latencies.extend(lats[li:])
            self.windows._cur.lateness.extend(lates[gi:])
            if lates[gi:]:
                self.windows._cur.lateness_by_class.setdefault(
                    name, []).extend(lates[gi:])
                self.stats[name].lateness.extend(lates[gi:])
        self._active.discard(job_id)
        self._maybe_finish()

    # ---- the control tick ---------------------------------------------------
    def _tick(self) -> None:
        self._tick_evt = None
        now = self.sim.now
        self._trim_arrivals(now)
        # 1. release queued jobs once the burst has cleared (rate signal
        #    only: identical release times across paired strategy runs) —
        #    in class order: heappop yields (rank, seq), so silver drains
        #    before best_effort regardless of queueing order
        released = 0
        while (self._queue and released < self.adm.dequeue_per_tick
               and len(self._arrivals) <= self.adm.burst_arrivals):
            _, _, since, name, jt = heapq.heappop(self._queue)
            self._admit(jt, self.stats[name], queued_since=since)
            released += 1
        # 2. autoscale the aggregator pool
        self._autoscale(now)
        # 3. stay alive while there is anything left to serve
        if not self._maybe_finish():
            self._tick_evt = self.sim.schedule(
                self.auto.control_interval_s, self._tick)

    def _weighted_backlog(self) -> Tuple[int, float]:
        """(raw, class-weighted) gated drain backlog. The weighted sum is
        the scale-up signal — queued gold updates count backlog_weight=1.0
        each, best_effort 0.25 — so the pool grows for gold pressure first.
        The raw sum feeds the unchanged scale-down hysteresis. All-gold
        (the single-class default) makes the two identical."""
        if not self.runner.use_scheduler:
            return 0, 0.0
        by_job = self.runner.scheduler.drain_backlog_by_job()
        raw = sum(by_job.values())
        weighted = 0.0
        for job_id, k in by_job.items():
            name = self.class_of.get(job_id)
            w = self.sla_classes[name].backlog_weight \
                if name is not None else 1.0
            weighted += k * w
        return raw, weighted

    def _autoscale(self, now: float) -> None:
        cap = self.cluster.capacity
        pending = len(self.cluster.pending)
        backlog, weighted = self._weighted_backlog()
        occ = self._mean_occupancy(now)
        tr = self.tracer
        if tr.enabled:
            tr.metrics.histogram("online.weighted_backlog").observe(weighted)
            tr.metrics.histogram("online.occupancy").observe(occ)
        if (pending >= self.auto.scale_up_pending
                or weighted >= self.auto.scale_up_backlog):
            self._idle_ticks = 0
            if cap < self._max_capacity:
                new = min(self._max_capacity, cap + self.auto.scale_up_step)
                self._resize(now, new)
                self.n_scale_ups += 1
                if tr.enabled:
                    # the decision AND the signals that drove it
                    tr.event(now, "online", "scale_up", None,
                             capacity=new, prev=cap, pending=pending,
                             backlog=backlog, weighted_backlog=weighted,
                             occupancy=occ)
        elif (pending == 0 and backlog < self.auto.scale_up_backlog
              and occ <= self.auto.scale_down_occupancy):
            # NB not backlog == 0: gated rounds hold arrived-but-unquorate
            # updates for most of their lifetime, so requiring an empty
            # backlog would pin the pool at its peak until total quiescence
            self._idle_ticks += 1
            if (self._idle_ticks >= self.auto.scale_down_ticks
                    and cap > self.auto.min_capacity):
                new = max(self.auto.min_capacity,
                          cap - self.auto.scale_down_step)
                self._resize(now, new)
                self.n_scale_downs += 1
                self._idle_ticks = 0
                if tr.enabled:
                    tr.event(now, "online", "scale_down", None,
                             capacity=new, prev=cap, pending=pending,
                             backlog=backlog, weighted_backlog=weighted,
                             occupancy=occ)
        else:
            self._idle_ticks = 0

    def _resize(self, now: float, new: int) -> None:
        self.cluster.resize(new)
        self.pool_timeline.append((now, new))

    def _frac_area(self, a: float, b: float, level: int) -> float:
        """Integral of ``level / cap(t)`` over [a, b], with cap(t) read
        from ``pool_timeline`` — the capacity in effect at each instant,
        not the current capacity (a resize inside the window would
        otherwise mis-normalize the whole window)."""
        if b <= a or level == 0:
            return 0.0
        tl = self.pool_timeline
        # rightmost step starting at or before a (timeline starts at the
        # service start time, so i >= 0 whenever a is inside the service)
        i = max(bisect.bisect_right(tl, (a, float("inf"))) - 1, 0)
        area, t = 0.0, a
        while t < b:
            cap = tl[i][1]
            nxt = tl[i + 1][0] if i + 1 < len(tl) else b
            seg_end = min(b, nxt)
            area += level * (seg_end - t) / max(cap, 1)
            t = seg_end
            i += 1
        return area

    def _mean_occupancy(self, now: float) -> float:
        """Trailing mean pool occupancy (fraction of capacity) since the
        last tick, integrated from ``Cluster.occupancy_events`` against the
        capacity *in effect at each event time* (``pool_timeline``), so a
        mid-window ``Cluster.resize`` — including a shrink below the live
        container count, idle_capacity < 0 — is normalized piecewise
        instead of against whatever the capacity happens to be now."""
        t0 = self._occ_prev_t
        ev = self.cluster.occupancy_events
        if now <= t0:
            return 0.0
        area, prev, level = 0.0, t0, self._occ_level
        while self._occ_idx < len(ev):
            t, delta = ev[self._occ_idx]
            if t > now:
                break  # future-stamped release (preemption checkpoint)
            t = max(t, prev)
            area += self._frac_area(prev, t, level)
            prev, level = t, level + delta
            self._occ_idx += 1
        area += self._frac_area(prev, now, level)
        self._occ_level = level
        self._occ_prev_t = now
        return area / (now - t0)

    # ---- quiescence -----------------------------------------------------------
    def _quiesced(self) -> bool:
        return (self.stream.closed and not self._inflight_arrival
                and not self._queue and not self._active)

    def _maybe_finish(self) -> bool:
        if self._done:
            return True
        if not self._quiesced():
            return False
        self._done = True
        if self._tick_evt is not None:
            self._tick_evt.cancel()
            self._tick_evt = None
        self.windows.close(self.sim.now)
        return True

    # ---- results ----------------------------------------------------------------
    def _preemptions_by_class(self) -> Dict[str, int]:
        """Cumulative §5.5 preemption counts attributed to the preempted
        job's SLA class, from the cluster's per-job ledger."""
        out: Dict[str, int] = {name: 0 for name in self.sla_classes}
        for job_id, n in self.cluster.n_preemptions_by_job.items():
            name = self.class_of.get(job_id)
            if name is not None:
                out[name] = out.get(name, 0) + n
        return out

    def _billed_container_seconds(self) -> float:
        """Cumulative billing over this service's jobs, summed in job
        insertion order from the cluster's per-job ledger — the identical
        float sum ``fleet_rollup`` computes, so the windowed rollup
        reconciles bit-for-bit on closed traces."""
        by_job = self.cluster.container_seconds_by_job
        return sum(by_job.get(job_id, 0.0) for job_id in self.runner.specs)

    def pool_container_seconds(self, horizon_s: Optional[float] = None) -> float:
        """Integral of pool capacity over [start, horizon] — what a
        reserved pool following the autoscaler's timeline would bill."""
        horizon = self.sim.now if horizon_s is None else horizon_s
        total = 0.0
        for (t0, cap), (t1, _) in zip(
                self.pool_timeline,
                self.pool_timeline[1:] + [(horizon, 0)]):
            total += cap * max(0.0, min(t1, horizon) - t0)
        return total

    def result(self) -> OnlineReport:
        """The end-of-service report (after ``drain()`` or once ``done``)."""
        if not self._done:
            raise RuntimeError(
                "service still live; drain() it (or advance until done) "
                "before reading result() — poll() works mid-run")
        res = self.runner.result()
        for name, n in self._preemptions_by_class().items():
            if name in self.stats:
                self.stats[name].preemptions = n
        return OnlineReport(
            strategy=self.strategy_name,
            jobs=res.jobs,
            fleet=res.fleet,
            windows=self.windows.snapshot(),
            rollup=self.windows.rollup(),
            classes=self.stats,
            shed_jobs=list(self.shed_jobs),
            pool_timeline=list(self.pool_timeline),
            pool_container_seconds=self.pool_container_seconds(),
            peak_pool=max(cap for _, cap in self.pool_timeline),
        )
