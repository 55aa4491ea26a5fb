"""The JIT aggregation scheduler — faithful implementation of the paper's
Fig. 6 pseudocode, multi-job, over the shared cluster.

  upon ARRIVAL(J):      estimate t_upd per party, t_rnd = max, t_agg (§5.3-5.4)
  upon START_ROUND(J):  create aggregator task, priority := timer := t_rnd - t_agg
  upon TIMER_ALERT(A):  if not executing, force-trigger (deadline, §5.5)

A smaller priority value = more urgent. Between the round start and the
deadline, the cluster may opportunistically run the aggregator early when it
has idle capacity (scheduling decisions every delta seconds); if
higher-priority work arrives, running aggregators are preempted and their
partially-aggregated state checkpointed to the message queue (§5.5).

Two driving modes per job:

  estimate-driven (default) — the round's aggregation task is submitted at
  START_ROUND with work sized from the estimator; no party events exist,
  so the scheduler observes only §5.5 lateness.

  arrival-gated (``upon_arrival(job, gated=True)``, the ``repro.fleet``
  vehicle) — simulated parties deliver per-round update arrivals via
  ``deliver_update``; aggregation work is submitted only once the quorum
  has actually arrived (or the Fig. 6 deadline timer fires), the predictor
  is calibrated online from every arrival, and completion is timed against
  the round's true last arrival, so the scheduler vehicle finally observes
  §6.2 aggregation latency (``core.metrics.aggregation_latency``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster, Task
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import EventHandle, Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import (
    JobMetrics,
    aggregation_latency,
    sla_lateness,
)
from repro_torch.core.prediction import UpdatePredictor
from repro_torch.core.queue import MessageQueue


@dataclasses.dataclass
class JobState:
    job: FLJobSpec
    predictor: UpdatePredictor
    #: SLA-class rank (0 = gold). Every drain this job submits carries it,
    #: so task priority on the shared pool is (class_rank, deadline) —
    #: §5.5 priority scheduling across admission classes (repro.online).
    class_rank: int = 0
    t_rnd: float = 0.0
    t_agg: float = 0.0
    round_idx: int = 0
    round_start: float = 0.0
    task: Optional[Task] = None
    timer: Optional[EventHandle] = None
    executing: bool = False
    done_rounds: int = 0
    # SLA lateness per round: completion − (round_start + t_rnd)
    lateness: List[float] = dataclasses.field(default_factory=list)
    finished_at: Optional[float] = None  # this job's last aggregation time
    # (t_rnd, t_agg) predictions per round (what the timer defended)
    predictions: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    # ---- arrival-gated mode (repro.fleet: simulated per-job parties) ----
    gated: bool = False
    deadline: float = 0.0  # absolute force-trigger time of this round
    armed: bool = False  # deadline timer fired (force-trigger mode)
    expected: int = 0  # arrivals still possible this round (minus no-shows)
    arrived: int = 0  # updates arrived this round
    submitted: int = 0  # updates covered by submitted drain tasks
    aggregated: int = 0  # updates fused this round
    last_arrival: Optional[float] = None
    first_drain_t: Optional[float] = None  # first drain submission time
    # when the round's first drain actually began EXECUTING on the pool —
    # §5.4 calibration measures from here, not from submission, so time
    # spent queued behind other jobs on a saturated cluster is never
    # misattributed to t_pair (that feedback loop diverges: queue wait
    # inflates t_pair, which inflates drain work, which grows the queue)
    first_drain_exec_t: Optional[float] = None
    updates_received: int = 0  # job-lifetime arrivals
    no_shows: int = 0  # job-lifetime dropouts
    quorum_failures: int = 0  # rounds that closed below quorum
    # §6.2 aggregation latency per round: completion − last actual arrival
    latencies: List[float] = dataclasses.field(default_factory=list)
    # ---- presampled fast path (begin_round_presampled) ----
    fast: bool = False  # this round's arrivals are presampled
    arrival_times: Optional[np.ndarray] = None  # sorted absolute times
    trigger: Optional[EventHandle] = None  # next analytic drain trigger

    def to_metrics(self, cluster: Cluster, price: float) -> "JobMetrics":
        """This job's scheduler-vehicle JobMetrics, billing read live from
        the cluster (the one builder for Platform and FleetRunner).

        §6.2 ``round_latencies`` are populated only by arrival-gated jobs;
        estimate-driven jobs observe §5.5 ``round_lateness`` alone."""
        m = JobMetrics(self.job.job_id, "jit-scheduled")
        m.rounds_done = self.done_rounds
        m.round_latencies = list(self.latencies)
        m.round_lateness = list(self.lateness)
        m.predictions = list(self.predictions)
        m.updates_received = self.updates_received
        m.dropped_updates = self.no_shows
        m.quorum_failures = self.quorum_failures
        m.container_seconds = cluster.container_seconds_by_job.get(
            self.job.job_id, 0.0)
        m.cost_usd = m.container_seconds * price
        m.n_deploys = cluster.n_deploys_by_job.get(self.job.job_id, 0)
        m.finished_at = self.finished_at  # this job's last aggregation
        return m


class JITScheduler:
    """Schedules aggregation for many concurrent FL jobs on one cluster.

    With ``auto_restart`` (the ``repro.api.Platform`` default) the next
    round of each job starts ``round_gap_s`` after the previous fused model
    is redistributed, until ``job.rounds`` rounds complete; otherwise the
    caller drives ``start_round`` (e.g. from ``on_aggregated``).
    """

    def __init__(
        self,
        sim: Simulator,
        cluster: Cluster,
        estimator: AggregationEstimator,
        queue: Optional[MessageQueue] = None,
        on_aggregated: Optional[Callable[[str, int, float], None]] = None,
        priority_policy: str = "deadline",  # "deadline" (§5.5) | "fifo"
        auto_restart: bool = False,
        round_gap_s: float = 1.0,
        on_round_start: Optional[Callable[[str, int], None]] = None,
    ):
        assert priority_policy in ("deadline", "fifo"), priority_policy
        self.sim = sim
        self.cluster = cluster
        # sim-time tracer (repro.obs) — shared with the cluster, emission
        # guarded on ``enabled`` (free when disabled)
        self.tracer = cluster.tracer
        self.est = estimator
        self.queue = queue or MessageQueue()
        self.jobs: Dict[str, JobState] = {}
        self.on_aggregated = on_aggregated  # (job_id, round, completion_t)
        self.priority_policy = priority_policy
        self.auto_restart = auto_restart
        self.round_gap_s = round_gap_s
        self.on_round_start = on_round_start  # (job_id, round_idx)

    # ---- Fig. 6 line 1: upon ARRIVAL -----------------------------------------
    def upon_arrival(self, job: FLJobSpec, *, gated: bool = False,
                     predictor=None, class_rank: int = 0) -> JobState:
        job.validate()
        st = JobState(job=job,
                      predictor=predictor if predictor is not None
                      else UpdatePredictor(job),
                      gated=gated, class_rank=class_rank)
        st.t_rnd = st.predictor.t_rnd()  # lines 6-11
        st.t_agg = self.est.t_agg(job)  # line 13
        self.jobs[job.job_id] = st  # line 12 (FLJOBS[J])
        return st

    # ---- Fig. 6 line 14: upon START_ROUND --------------------------------------
    def start_round(self, job_id: str) -> None:
        st = self.jobs[job_id]
        st.round_start = self.sim.now
        st.executing = False
        # refresh estimates from the predictor's online observations
        st.t_rnd = st.predictor.t_rnd()
        st.t_agg = self.est.t_agg(st.job)
        st.predictions.append((st.t_rnd, st.t_agg))
        defer = max(0.0, st.t_rnd - st.t_agg)
        st.deadline = st.round_start + defer  # line 17 (absolute deadline)
        if st.gated:
            # arrival-gated round: nothing is queued yet, so no task is
            # submitted — drains are triggered by deliver_update / the timer
            st.armed = False
            st.expected = st.job.n_parties
            st.arrived = st.submitted = st.aggregated = 0
            st.last_arrival = None
            st.first_drain_t = None
            st.first_drain_exec_t = None
            st.task = None
            if st.trigger is not None:
                st.trigger.cancel()
                st.trigger = None
            st.arrival_times = None
        else:
            st.task = self.cluster.submit(
                job_id,
                priority=self._priority(st),
                work_s=self._round_work(st),
                on_complete=lambda t, j=job_id: self._aggregated(j, t),
                preemptible=True,
                class_rank=st.class_rank,
            )
        st.timer = self.sim.schedule_at(
            st.deadline, lambda j=job_id: self.timer_alert(j)
        )  # line 18
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "scheduler", "round_open", job_id,
                     round=st.round_idx, t_rnd=st.t_rnd, t_agg=st.t_agg,
                     deadline=st.deadline, gated=st.gated)
        if self.on_round_start:
            self.on_round_start(job_id, st.round_idx)

    # ---- Fig. 6 line 19: upon TIMER_ALERT ----------------------------------------
    def timer_alert(self, job_id: str) -> None:
        st = self.jobs.get(job_id)
        if st is None:
            return
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "scheduler", "deadline_fire", job_id,
                     round=st.round_idx, armed=st.gated,
                     arrived=st.arrived, expected=st.expected,
                     in_flight=st.task is not None)
        if st.gated:
            st.armed = True
            st.timer = None
            if st.task is not None:
                # a drain is queued/running: force it to the front (line 21)
                self.cluster.boost(st.task, float("-inf"))
            else:
                # work-conserving §5.5: with no quorum queued yet this is a
                # no-op; the next deliver_update (or, on the presampled
                # path, the analytic trigger) re-checks the armed state
                if st.fast and st.arrival_times is not None:
                    self._fast_sync(st)
                self._maybe_drain(st)
            return
        if st.task is None or st.executing:
            return
        # force trigger: boost to highest priority so the next tick starts it
        self.cluster.boost(st.task, float("-inf"))  # line 21

    # ---- internals ------------------------------------------------------------
    def _priority(self, st: JobState) -> float:
        # §5.5 sets priority == deadline (earliest-deadline-first under
        # contention); the "fifo" baseline orders by submission time only
        return st.deadline if self.priority_policy == "deadline" \
            else st.round_start

    def _unit_work(self, st: JobState) -> float:
        from repro_torch.core.estimator import usable_cores

        res = self.est.resources
        return self.est.t_pair_for(st.job.model_bytes) / (
            usable_cores(res, st.job.model_bytes) * res.n_aggregators
        )

    def _round_work(self, st: JobState) -> float:
        res = self.est.resources
        return (st.job.quorum * self._unit_work(st)
                + st.job.model_bytes / res.intra_dc_bw)

    def _aggregated(self, job_id: str, t: float) -> None:
        st = self.jobs[job_id]
        st.executing = False
        if st.timer:
            st.timer.cancel()
        observed = t - st.round_start - max(0.0, st.t_rnd - st.t_agg)
        self._calibrate(st, t, max(observed, 1e-6), st.job.quorum)
        st.lateness.append(sla_lateness(t, st.round_start, st.t_rnd))
        self._round_complete(st, t)

    def _calibrate(self, st: JobState, t: float, observed_t_agg: float,
                   n_updates: int) -> None:
        """§5.4 estimator calibration, traced before→after so a future
        t_pair ratchet is visible in one glance."""
        tr = self.tracer
        if not tr.enabled:
            self.est.calibrate(observed_t_agg, st.job, n_updates)
            return
        t_pair_before = self.est.t_pair_for(st.job.model_bytes)
        t_agg_before = self.est.t_agg(st.job)
        self.est.calibrate(observed_t_agg, st.job, n_updates)
        tr.event(t, "calibration", "t_pair", st.job.job_id,
                 round=st.round_idx, observed_t_agg_s=observed_t_agg,
                 n_updates=n_updates, t_pair_before=t_pair_before,
                 t_pair_after=self.est.t_pair_for(st.job.model_bytes),
                 t_agg_before=t_agg_before,
                 t_agg_after=self.est.t_agg(st.job),
                 source=("cost_table" if self.est.cost_table is not None
                         else "constant"))

    def _round_complete(self, st: JobState, t: float) -> None:
        tr = self.tracer
        if tr.enabled:
            tr.event(t, "scheduler", "round_close", st.job.job_id,
                     round=st.round_idx, aggregated=st.aggregated,
                     no_shows_round=max(st.job.n_parties - st.expected, 0)
                     if st.gated else 0,
                     last_lateness_s=st.lateness[-1]
                     if st.lateness else None,
                     last_latency_s=st.latencies[-1]
                     if st.latencies else None)
            if st.lateness:
                tr.metrics.histogram(
                    "scheduler.round_lateness_s").observe(st.lateness[-1])
            if st.latencies:
                tr.metrics.histogram(
                    "scheduler.round_latency_s").observe(st.latencies[-1])
        st.finished_at = t
        st.done_rounds += 1
        st.round_idx += 1
        if self.on_aggregated:
            self.on_aggregated(st.job.job_id, st.round_idx - 1, t)
        if self.auto_restart and st.done_rounds < st.job.rounds:
            self.sim.schedule(self.round_gap_s,
                              lambda j=st.job.job_id: self.start_round(j))

    # ---- control-plane signals (repro.online autoscaler) --------------------------
    def drain_backlog(self) -> int:
        """Updates queued for aggregation but not yet covered by a
        submitted drain task, summed over arrival-gated jobs — together
        with ``len(cluster.pending)`` this is the open-loop controller's
        scale-up pressure signal."""
        return sum(self.drain_backlog_by_job().values())

    def drain_backlog_by_job(self) -> Dict[str, int]:
        """Per-job drain backlog (arrival-gated jobs only) — the online
        autoscaler weights each job's backlog by its SLA class, so queued
        gold work applies more scale-up pressure than best_effort."""
        out: Dict[str, int] = {}
        for job_id, st in self.jobs.items():
            if not st.gated:
                continue
            if st.fast and st.arrival_times is not None:
                self._fast_sync(st)  # presampled arrivals land lazily
            out[job_id] = max(st.arrived - st.submitted, 0)
        return out

    # ---- feedback from parties ---------------------------------------------------
    def observe_update(self, job_id: str, party_id: str,
                       train_time_s: float) -> None:
        self.jobs[job_id].predictor.observe_round(party_id, train_time_s)

    # ---- arrival-gated rounds (simulated per-job parties, repro.fleet) -----------
    def deliver_update(self, job_id: str, party_id: str,
                       train_time_s: float) -> None:
        """A simulated party's update arrived NOW: calibrate the predictor
        (online t_upd/t_rnd learning) and gate this round's drain on it."""
        self.observe_update(job_id, party_id, train_time_s)
        st = self.jobs[job_id]
        tr = self.tracer
        if tr.enabled:
            # one predictor observation per arrival (legacy per-event path)
            tr.event(self.sim.now, "scheduler", "update_arrival", job_id,
                     party=party_id, train_s=train_time_s,
                     round=st.round_idx)
        if not st.gated:
            return
        st.arrived += 1
        st.updates_received += 1
        st.last_arrival = self.sim.now
        self._maybe_drain(st)

    def party_no_show(self, job_id: str) -> None:
        """A party drops out this round (§2.2): one fewer arrival to wait
        for. With every remaining arrival already fused, the round ends."""
        st = self.jobs[job_id]
        assert st.gated, "no-show reporting is an arrival-gated-mode event"
        st.expected -= 1
        st.no_shows += 1
        if st.arrived >= st.expected:
            if st.arrived == 0 and st.expected <= 0:
                # the entire round dropped out: a failed round (§5.1)
                st.quorum_failures += 1
                if st.timer:
                    st.timer.cancel()
                self._round_complete(st, self.sim.now)
                return
            if st.task is None and st.aggregated >= st.arrived:
                self._finish_gated_round(st)
            else:
                self._maybe_drain(st)

    def _maybe_drain(self, st: JobState) -> bool:
        """Submit a drain task for the queued updates when the round is
        triggerable: every possible arrival is in, or the deadline passed
        with at least a quorum queued. Returns True when work was queued."""
        if st.task is not None:
            return False  # one drain in flight at a time
        backlog = st.arrived - st.submitted
        if backlog <= 0:
            return False
        all_in = st.arrived >= st.expected
        quorum = min(st.job.quorum, max(st.expected, 1))
        if not (all_in or (st.armed and st.arrived >= quorum)):
            return False
        work = backlog * self._unit_work(st)
        if st.first_drain_t is None:
            st.first_drain_t = self.sim.now
            # the fused-model broadcast is paid once per round (§5.4 comm)
            work += st.job.model_bytes / self.est.resources.intra_dc_bw
        st.submitted += backlog
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "scheduler", "drain_submit",
                     st.job.job_id, round=st.round_idx, k=backlog,
                     work_s=work, armed=st.armed, all_in=all_in,
                     first=st.first_drain_t == self.sim.now)
            tr.metrics.histogram("scheduler.drain_k").observe(backlog)
        st.task = self.cluster.submit(
            st.job.job_id,
            priority=float("-inf") if st.armed else self._priority(st),
            work_s=work,
            on_complete=lambda t, k=backlog, j=st.job.job_id:
                self._drained(j, k, t),
            preemptible=True,
            class_rank=st.class_rank,
        )
        return True

    def _drained(self, job_id: str, k: int, t: float) -> None:
        st = self.jobs[job_id]
        st.aggregated += k
        if st.first_drain_exec_t is None and st.task is not None \
                and st.task.started_at is not None:
            # actual pool start of this round's first drain (post-queueing;
            # after a preemption this is the restart, which only shortens
            # the observation — calibration stays conservative)
            st.first_drain_exec_t = st.task.started_at
        st.task = None
        if st.fast and st.arrival_times is not None:
            self._fast_sync(st)
        if st.arrived > st.submitted:
            # tail updates landed while the drain ran: fuse them too
            self._maybe_drain(st)
            if st.fast and st.task is None:
                self._fast_arm_trigger(st)  # not yet triggerable: re-arm
            return
        if st.arrived < st.expected:
            # more arrivals coming; the next delivery (or the analytic
            # trigger on the presampled path) re-triggers
            if st.fast:
                self._fast_arm_trigger(st)
            return
        self._finish_gated_round(st)

    # ---- presampled fast rounds (vectorized FleetRunner path) ----------------
    #
    # With a round's arrivals presampled and sorted up front, the per-arrival
    # simulator events the legacy path schedules are redundant: the only
    # times anything can HAPPEN are (i) the Fig. 6 deadline timer and (ii)
    # the analytically-computable moments a drain first becomes submittable.
    # The scheduler therefore keeps ONE trigger event per job round —
    # `arrived`/`last_arrival` are synced lazily from the sorted time array
    # (searchsorted against sim.now) — turning O(parties) events per round
    # into O(drains). Drain submission times, work sizes, and the §5.4/§6.2
    # bookkeeping are exactly the legacy path's (locked by the fast==legacy
    # equality test); the one visible difference is that `updates_received`
    # counts a round's arrivals at round start, so a mid-round `run(until=)`
    # cutoff reports round-granular arrival counts.

    def begin_round_presampled(
        self,
        job_id: str,
        times_sorted: np.ndarray,
        present_idx: np.ndarray,
        train_times: np.ndarray,
        n_no_shows: int,
    ) -> None:
        """Feed one presampled round to an arrival-gated job: absolute
        arrival times (sorted), the present parties' predictor indices +
        observed train times (batch calibration), and the no-show count.
        Call right after ``start_round``."""
        st = self.jobs[job_id]
        assert st.gated, "presampled rounds are an arrival-gated-mode path"
        st.fast = True
        # batch the whole round's predictor feed: per-party trackers are
        # independent and t_rnd is next read at the next start_round, by
        # which point the legacy per-arrival feed has the same state
        if len(present_idx):
            st.predictor.observe_batch(present_idx, train_times)
            tr = self.tracer
            if tr.enabled:
                # one batch predictor observation per presampled round
                tr.event(self.sim.now, "scheduler",
                         "predictor_observe_batch", job_id,
                         round=st.round_idx, n=int(len(present_idx)),
                         no_shows=int(n_no_shows))
        st.updates_received += int(len(present_idx))
        st.arrival_times = times_sorted
        round_before = st.round_idx
        if n_no_shows:
            self.party_no_shows(job_id, n_no_shows)
            if st.round_idx != round_before:
                return  # the whole round dropped out and completed
        self._fast_arm_trigger(st)

    def party_no_shows(self, job_id: str, k: int) -> None:
        """Batch §2.2 no-show report — same end-of-round logic as ``k``
        scalar ``party_no_show`` calls (intermediate states are inert:
        the end checks only depend on the final counts)."""
        if k <= 0:
            return
        st = self.jobs[job_id]
        assert st.gated, "no-show reporting is an arrival-gated-mode event"
        st.expected -= k
        st.no_shows += k
        if st.arrived >= st.expected:
            if st.arrived == 0 and st.expected <= 0:
                # the entire round dropped out: a failed round (§5.1)
                st.quorum_failures += 1
                if st.timer:
                    st.timer.cancel()
                if st.trigger is not None:
                    st.trigger.cancel()
                    st.trigger = None
                self._round_complete(st, self.sim.now)
                return
            if st.task is None and st.aggregated >= st.arrived:
                self._finish_gated_round(st)
            else:
                self._maybe_drain(st)

    def _fast_sync(self, st: JobState) -> None:
        """Lazily absorb presampled arrivals with time <= now."""
        times = st.arrival_times
        if times is None:
            return
        n = int(np.searchsorted(times, self.sim.now, side="right"))
        if n > st.arrived:
            st.arrived = n
            st.last_arrival = float(times[n - 1])

    def _fast_next_trigger(self, st: JobState) -> Optional[float]:
        """Earliest future moment a drain becomes submittable, in closed
        form over the sorted arrival times: either every arrival is in
        (times[E-1]) or the deadline has passed with a quorum queued and a
        positive backlog (max(deadline, times[max(submitted, Q-1)]))."""
        times = st.arrival_times
        if times is None:
            return None
        e = len(times)
        if e == 0 or st.submitted >= e:
            return None
        quorum = min(st.job.quorum, max(st.expected, 1))
        q_at = max(st.submitted, quorum - 1)
        if q_at >= e:
            return float(times[e - 1])
        return float(min(times[e - 1],
                         max(st.deadline, float(times[q_at]))))

    def _fast_arm_trigger(self, st: JobState) -> None:
        if st.trigger is not None:
            st.trigger.cancel()
            st.trigger = None
        t = self._fast_next_trigger(st)
        if t is None:
            return
        st.trigger = self.sim.schedule_at(
            max(t, self.sim.now),
            lambda j=st.job.job_id: self._fast_trigger(j))

    def _fast_trigger(self, job_id: str) -> None:
        st = self.jobs.get(job_id)
        if st is None or not st.gated or st.arrival_times is None:
            return
        st.trigger = None
        self._fast_sync(st)
        self._maybe_drain(st)
        if st.task is None:
            # not triggerable yet (e.g. quorum before the deadline): re-arm
            self._fast_arm_trigger(st)

    def _finish_gated_round(self, st: JobState) -> None:
        t = self.sim.now
        if st.timer:
            st.timer.cancel()
        if st.trigger is not None:
            st.trigger.cancel()
            st.trigger = None
        st.arrival_times = None
        if st.expected < st.job.quorum:
            st.quorum_failures += 1  # round closed below quorum (§5.1)
        # §5.4 online calibration from the observed aggregation duration:
        # completion − max(first drain EXECUTION start, last arrival), so
        # neither tail-arrival gaps between drains nor time spent queued
        # behind other jobs on a saturated pool inflates the t_agg
        # estimate (queue wait fed back into t_pair diverges: bigger
        # t_pair -> bigger drain work -> longer queues -> bigger t_pair)
        begun0 = (st.first_drain_exec_t if st.first_drain_exec_t is not None
                  else st.first_drain_t)
        if begun0 is not None and st.aggregated > 0:
            begun = max(begun0,
                        st.last_arrival if st.last_arrival is not None
                        else begun0)
            self._calibrate(st, t, max(t - begun, 1e-6), st.aggregated)
        # the two per-round timeline metrics, shared definitions
        if st.last_arrival is not None:
            st.latencies.append(aggregation_latency(t, st.last_arrival))
        st.lateness.append(sla_lateness(t, st.round_start, st.t_rnd))
        self._round_complete(st, t)
