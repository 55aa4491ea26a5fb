"""Simulated datacenter cluster: container pool with deploy / state-load /
checkpoint overheads, priority scheduling every delta seconds, and
preemption by checkpointing partial state (§5.5).

Container-seconds accounting follows §6.2: every second a container is
alive — including deployment, state loading and checkpointing — is billed.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.events import EventHandle, Simulator
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    capacity: int = 64  # max concurrent containers
    # Ray-executor-style overheads (the paper runs aggregation as Ray
    # serverless functions on a pre-provisioned k8s cluster, §6.1): task
    # launch is sub-second; state load/checkpoint move the running
    # aggregate through the object store and scale with model size (set
    # them per-workload: model_bytes / B_dc).
    deploy_overhead_s: float = 0.1  # schedule + start a Ray executor task
    state_load_s: float = 0.05  # load aggregator state from object store
    checkpoint_s: float = 0.05  # persist state at shutdown/preemption
    delta_s: float = 1.0  # scheduling tick (paper's delta)
    price_per_container_s: float = 0.0002692  # US$ (Azure ACI, paper Fig. 9)
    # occupancy recording (the fleet utilization timeline). Adjacent
    # same-timestamp deltas are always merged (exact — binning integrates
    # per distinct time). For long-horizon / fleet-scale traces the event
    # list is otherwise unbounded: set occupancy_resolution_s > 0 to bucket
    # event times (bounds memory at ~capacity x horizon/resolution entries,
    # coarsens the timeline by at most one bucket), or record_occupancy
    # False to drop recording entirely (timeline reads as empty).
    record_occupancy: bool = True
    occupancy_resolution_s: float = 0.0


@dataclasses.dataclass
class Task:
    """A unit of aggregation work submitted to the cluster."""

    task_id: int
    job_id: str
    priority: float  # smaller = more urgent (JIT: t_rnd - t_agg)
    work_s: float  # pure compute seconds remaining
    on_complete: Callable[[float], None]  # called with completion time
    preemptible: bool = True
    # SLA-class rank (repro.online): effective task priority is the pair
    # (class_rank, priority), so a rank-0 (gold) drain outranks ANY lower
    # class — including a deadline-boosted one — and §5.5 preemption
    # crosses class boundaries. Rank 0 everywhere (the default) keeps the
    # single-class order exactly (priority, task_id), i.e. today's.
    class_rank: int = 0
    # bookkeeping
    started_at: Optional[float] = None
    container_id: Optional[int] = None
    _finish_evt: Optional[EventHandle] = None
    _work_started: Optional[float] = None
    # tracing only (set under the tracer guard; stays None when disabled):
    # last submit/requeue time, for the queue-wait histogram
    submitted_at: Optional[float] = None

    @property
    def urgency(self) -> Tuple[int, float]:
        """Effective §5.5 priority: class rank first, deadline second."""
        return (self.class_rank, self.priority)

    @property
    def order_key(self) -> Tuple[int, float, int]:
        """Deterministic total order: urgency, then task_id — equal-urgency
        ties can never depend on incidental list/dict position, so paired
        strategy comparisons cannot diverge on tie order."""
        return (self.class_rank, self.priority, self.task_id)


class Cluster:
    def __init__(self, sim: Simulator, config: ClusterConfig, tracer=None):
        self.sim = sim
        self.cfg = config
        # sim-time tracer (repro.obs). Defaults to the shared no-op
        # singleton; every emission site is guarded on ``tracer.enabled``
        # so the disabled hot path costs one attribute read + branch.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # live pool size; starts at the configured capacity and may be
        # resized mid-run by an autoscaler (repro.online). cfg.capacity
        # stays the initial/provisioned value.
        self.capacity: int = config.capacity
        self.pending: List[Task] = []
        self.running: Dict[int, Task] = {}
        self._ids = itertools.count()
        self._cids = itertools.count()
        # metrics
        self.container_seconds: float = 0.0
        self.container_seconds_by_job: Dict[str, float] = {}
        self.n_deploys: int = 0
        self.n_deploys_by_job: Dict[str, int] = {}
        self.n_preemptions: int = 0
        self.n_preemptions_by_job: Dict[str, int] = {}
        # container occupancy deltas (t, ±1) — covers pooled tasks plus any
        # always-on / streaming containers that register via note_container;
        # repro.fleet bins these into a cluster-utilization timeline
        self.occupancy_events: List[Tuple[float, int]] = []
        self._tick_scheduled = False

    # ---- public API --------------------------------------------------------
    def submit(
        self,
        job_id: str,
        priority: float,
        work_s: float,
        on_complete: Callable[[float], None],
        preemptible: bool = True,
        class_rank: int = 0,
    ) -> Task:
        t = Task(next(self._ids), job_id, priority, work_s, on_complete,
                 preemptible, class_rank)
        self.pending.append(t)
        tr = self.tracer
        if tr.enabled:
            t.submitted_at = self.sim.now
            tr.event(self.sim.now, "cluster", "task_submit", job_id,
                     task=t.task_id, priority=priority,
                     class_rank=class_rank, work_s=work_s,
                     preemptible=preemptible)
        self._ensure_tick()
        return t

    def boost(self, task: Task, new_priority: float) -> None:
        """Raise a task's urgency to at most ``new_priority`` (Fig. 6 line
        21 force-trigger). Never *lowers* urgency — ``min`` keeps an
        already-boosted task boosted — never changes ``class_rank``, and
        never evicts anything by itself: a boosted non-preemptible task
        simply sorts earlier in the pending queue."""
        task.priority = min(task.priority, new_priority)
        self._ensure_tick()

    def idle_capacity(self) -> int:
        return self.capacity - len(self.running)

    def resize(self, capacity: int) -> None:
        """Resize the aggregator pool (online autoscaling, repro.online).

        Growing may start queued tasks at the next scheduling tick;
        shrinking never evicts running tasks — the pool drains down to the
        new size as they finish (idle_capacity simply stays <= 0 until
        then)."""
        if capacity < 1:
            raise ValueError(f"pool capacity must be >= 1, got {capacity}")
        grew = capacity > self.capacity
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "cluster", "pool_resize", None,
                     capacity=capacity, prev=self.capacity,
                     running=len(self.running), pending=len(self.pending))
        self.capacity = capacity
        if grew and self.pending:
            self._ensure_tick()

    def record_deploy(self, job_id: str) -> None:
        """Count one container deployment (cluster-wide and per job)."""
        self.n_deploys += 1
        self.n_deploys_by_job[job_id] = (
            self.n_deploys_by_job.get(job_id, 0) + 1
        )

    def note_container(self, t: float, delta: int) -> None:
        """Record a container coming up (+1) or going down (-1) at time t.

        Same-timestamp deltas merge in place (net-zero entries are
        dropped): the rollup timeline integrates between distinct times,
        so merging is exact — it only bounds the list on event-dense
        traces. ``occupancy_resolution_s`` additionally buckets t."""
        if not self.cfg.record_occupancy:
            return
        res = self.cfg.occupancy_resolution_s
        if res > 0.0:
            t = int(t / res) * res
        ev = self.occupancy_events
        if ev and ev[-1][0] == t:
            merged = ev[-1][1] + delta
            if merged == 0:
                ev.pop()
            else:
                ev[-1] = (t, merged)
        else:
            ev.append((t, delta))

    # ---- scheduling tick (every delta seconds while work exists) -----------
    def _ensure_tick(self) -> None:
        if not self._tick_scheduled:
            self._tick_scheduled = True
            self.sim.schedule(0.0, self._tick)

    def _tick(self) -> None:
        self._tick_scheduled = False
        self.pending.sort(key=lambda t: t.order_key)
        # start as many pending tasks as capacity allows
        while self.pending and self.idle_capacity() > 0:
            self._start(self.pending.pop(0))
        # preemption: a strictly-higher-urgency pending task evicts the
        # worst running preemptible task (§5.5). Urgency is (class_rank,
        # priority): a gold drain preempts a running best_effort drain
        # even if the victim was deadline-boosted, while same-class
        # contention stays earliest-deadline-first. The victim choice
        # breaks equal-urgency ties on task_id (deterministic; never on
        # dict iteration order).
        while self.pending:
            cand = self.pending[0]
            victims = [
                t for t in self.running.values()
                if t.preemptible and t.urgency > cand.urgency
            ]
            if not victims:
                break
            victim = max(victims, key=lambda t: t.order_key)
            self._preempt(victim, by=cand)
            self._start(self.pending.pop(0))
        if self.pending:
            self._tick_scheduled = True
            self.sim.schedule(self.cfg.delta_s, self._tick)

    # ---- internals ----------------------------------------------------------
    def _start(self, task: Task) -> None:
        cid = next(self._cids)
        task.container_id = cid
        task.started_at = self.sim.now
        self.record_deploy(task.job_id)
        self.note_container(self.sim.now, +1)
        tr = self.tracer
        if tr.enabled:
            wait = (self.sim.now - task.submitted_at
                    if task.submitted_at is not None else 0.0)
            tr.event(self.sim.now, "cluster", "task_start", task.job_id,
                     task=task.task_id, container=cid, queue_wait_s=wait)
            tr.metrics.histogram("cluster.queue_wait_s").observe(wait)
        startup = self.cfg.deploy_overhead_s + self.cfg.state_load_s
        task._work_started = self.sim.now + startup
        self.running[task.task_id] = task
        task._finish_evt = self.sim.schedule(startup + task.work_s,
                                             lambda: self._finish(task))

    def _bill(self, task: Task, end: float) -> None:
        start = task.started_at if task.started_at is not None else end
        dur = end - start
        self.container_seconds += dur
        self.container_seconds_by_job[task.job_id] = (
            self.container_seconds_by_job.get(task.job_id, 0.0) + dur
        )
        # the container span carries the exact billed endpoints, so
        # span-derived per-job totals reconcile with the ledger exactly
        tr = self.tracer
        if tr.enabled:
            tr.span(start, end, "container", "task", job_id=task.job_id,
                    container_id=task.container_id, task=task.task_id)

    def _finish(self, task: Task) -> None:
        # checkpoint result to stable storage, then release the container
        self.running.pop(task.task_id, None)

        def complete():
            self._bill(task, self.sim.now)
            self.note_container(self.sim.now, -1)
            tr = self.tracer
            if tr.enabled:
                tr.event(self.sim.now, "cluster", "task_finish",
                         task.job_id, task=task.task_id,
                         container=task.container_id)
            task.on_complete(self.sim.now)
            self._ensure_tick()

        self.sim.schedule(self.cfg.checkpoint_s, complete)

    def _preempt(self, task: Task, by: Optional[Task] = None) -> None:
        assert task._finish_evt is not None
        task._finish_evt.cancel()
        self.n_preemptions += 1
        self.n_preemptions_by_job[task.job_id] = (
            self.n_preemptions_by_job.get(task.job_id, 0) + 1
        )
        # NB: _work_started == 0.0 is a valid start time, not "unset"
        ws = (task._work_started if task._work_started is not None
              else self.sim.now)
        done = max(0.0, self.sim.now - ws)
        task.work_s = max(0.0, task.work_s - done)
        self.running.pop(task.task_id, None)
        # checkpoint the partially-aggregated state (§5.5), bill, requeue
        end = self.sim.now + self.cfg.checkpoint_s
        tr = self.tracer
        if tr.enabled:
            # cause: the strictly-higher-urgency pending task that evicted
            # us (None only when preempted outside the §5.5 tick path)
            tr.event(self.sim.now, "cluster", "preempt", task.job_id,
                     task=task.task_id, container=task.container_id,
                     remaining_work_s=task.work_s, release_t=end,
                     by_job=by.job_id if by is not None else None,
                     by_task=by.task_id if by is not None else None,
                     by_urgency=list(by.urgency) if by is not None else None)
        self._bill(task, end)
        self.note_container(end, -1)
        task.started_at = None
        task.container_id = None
        self.sim.schedule_at(end, lambda: self._requeue(task))

    def _requeue(self, task: Task) -> None:
        self.pending.append(task)
        tr = self.tracer
        if tr.enabled:
            task.submitted_at = self.sim.now
            tr.event(self.sim.now, "cluster", "task_requeue", task.job_id,
                     task=task.task_id, remaining_work_s=task.work_s)
        self._ensure_tick()


class AlwaysOnContainer:
    """Dedicated always-on aggregator (the Eager-AO baseline): billed from
    job start to job end regardless of utilisation."""

    def __init__(self, cluster: Cluster, job_id: str):
        self.cluster = cluster
        self.job_id = job_id
        self.start_t = cluster.sim.now
        self.busy_until = cluster.sim.now
        self.work_done = 0.0
        cluster.note_container(self.start_t, +1)

    def process(self, work_s: float, on_complete: Callable[[float], None]):
        start = max(self.cluster.sim.now, self.busy_until)
        self.busy_until = start + work_s
        self.work_done += work_s
        self.cluster.sim.schedule_at(
            self.busy_until, lambda: on_complete(self.cluster.sim.now)
        )

    def shutdown(self) -> float:
        dur = self.cluster.sim.now - self.start_t
        self.cluster.note_container(self.cluster.sim.now, -1)
        self.cluster.container_seconds += dur
        self.cluster.container_seconds_by_job[self.job_id] = (
            self.cluster.container_seconds_by_job.get(self.job_id, 0.0) + dur
        )
        tr = self.cluster.tracer
        if tr.enabled:
            tr.span(self.start_t, self.cluster.sim.now, "container",
                    "always_on", job_id=self.job_id,
                    work_done_s=self.work_done)
        return dur
