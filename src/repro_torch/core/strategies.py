"""The four aggregation deployment strategies of §3 + the JIT strategy of §5,
driven over the discrete-event simulator.

  eager_ao          — always-on aggregator (IBM FL / FATE / NVFLARE style)
  eager_serverless  — deploy an aggregator per update arrival (Eager-λ)
  batched           — deploy per batch of updates (Batched-λ)
  lazy              — deploy once, after the last update arrives
  jit               — deploy at predicted (t_rnd - t_agg); timer + priority

Architecture: a shared ``RoundEngine`` owns everything strategy-independent
— party-arrival scheduling, round windows and quorum (§4.3/§5.1), metrics,
and the two execution vehicles (serverless task submission and the
streaming container). Each strategy is an ``AggregationStrategy`` plugin
(see ``repro.core.policy``) that receives engine callbacks and decides only
*when* to deploy; it is selected by name through the strategy registry, so
a new policy is a ``@register_strategy`` subclass, not an engine edit.
``STRATEGIES`` is derived from the registry.

Each strategy processes updates of one FL job over R synchronisation rounds;
parties are emulated with the paper's §6.3 arrival models. Metrics follow
§6.2: aggregation latency (completion - last update arrival) and container
seconds (including deploy/load/checkpoint overheads).

JIT details implemented from §5.5:
  * deadline timer at t_rnd − t_agg (priority value = the same quantity);
  * work-conserving: if the timer fires with no pending updates the task is
    deferred by δ, retaining its priority ("If there are no pending updates
    to aggregate, the JIT scheduler defers aggregation tasks");
  * all-arrived early trigger: once every expected update is in the queue
    there is nothing left to defer for;
  * opportunistic early drains when the cluster is idle and enough work is
    pending to amortise a deployment (the greedy/priority path);
  * keep-alive policy while deployed: when the queue runs dry the container
    is kept hot only if the expected wait for the next update costs less
    than a checkpoint + redeploy cycle, otherwise state is checkpointed and
    the container released (redeployed on the next arrival).

Beyond-paper refinements (``jit_policy="orderstat"``, the default):

  1. Order-statistic t_rnd for intermittent parties: the paper predicts
     t_rnd = t_wait (Fig. 6 line 7), an upper bound — the actual last
     update of N parties sending at uniformly random times lands at
     E[max] = t_comm + (t_wait − t_comm)·N/(N+1). ``margin_sigmas`` adds a
     safety margin of that many standard deviations of the max order
     statistic (capped at the window boundary) for noise-robust deploys.
  2. Backlog-fill trigger: instead of the paper's fixed timer at
     t_rnd − t_agg(N) (which counts fuse work for all N updates even
     though only the queued backlog is actually waiting), deploy when
       (t_rnd_exp − now) ≤ oh_startup + len(pending)·w_u,
     i.e. when the queued work exactly fills the time left until the
     predicted last arrival. The drain then completes ≈ t_rnd with zero
     container idle. The paper's own timer is kept as the SLA backstop
     (force-trigger, Fig. 6 line 19-21).

``jit_policy="paper"`` reproduces Fig. 6 literally (fixed timer, t_wait
prediction for intermittent parties). Both policies share the
work-conserving defer, all-arrived trigger and keep-alive economics.
``jit_policy="fixed"`` is the fully deterministic timeline the real
training vehicle (``repro.fl.job.FLJobRuntime``) has always priced: deploy
exactly at t_rnd − t_agg, keep the container hot until the round's last
update is fused, and calibrate the t_agg estimator online from the
observed drain.

The engine is driven by an ``ArrivalSource``: the sampled §6.3
``ArrivalModel`` for simulation, or ``MeasuredArrivals`` replaying real
measured train/comm times — so one real training run can be priced under
every registered strategy (see ``repro.api.replay_measured``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.core.cluster import AlwaysOnContainer, Cluster, ClusterConfig
from repro_torch.core.estimator import AggregationEstimator, usable_cores
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import JobMetrics, aggregation_latency, sla_lateness
from repro_torch.core.policy import (
    AggregationStrategy,
    PolicyConfig,
    as_policy,
    available_strategies,
    get_strategy,
    register_strategy,
)
from repro_torch.core.prediction import UpdatePredictor


# --------------------------------------------------------------------------
# arrival sources: where a round's update-arrival offsets come from
# --------------------------------------------------------------------------
class ArrivalSource:
    """What drives a ``RoundEngine``: per-party update-arrival offsets.

    Two implementations ship: the paper's §6.3 sampled ``ArrivalModel``
    (simulation) and ``MeasuredArrivals`` (replay of real measured
    train/comm times from ``FLJobRuntime``). The engine is agnostic — the
    same strategy plugins price either source, which is what lets one real
    training run be costed under every registered deployment policy.

    ``announces_presence`` declares whether a ``None`` from
    ``sample_arrival`` is an *up-front* §2.2 no-show announcement (the
    party declares at round start that it will skip the round, the same
    knowledge ``JITScheduler.party_no_show`` gives the scheduler vehicle)
    or a silent dropout the engine only discovers at the §4.3 window
    close. ``repro.fleet``'s ``FleetArrivalSource`` announces, so engine
    baselines and the scheduler see the same no-show sequence and
    dropout-pattern latency comparisons are presence-fair.
    """

    #: True when a None arrival is announced at round start (§2.2 presence
    #: signal) rather than discovered at the §4.3 window close.
    announces_presence: bool = False

    def start_round(self, round_idx: int) -> None:
        """Called by the engine when round `round_idx` begins."""

    def sample_arrival(self, pid: str) -> Optional[float]:
        """Offset of the party's update arrival from the round start, or
        None when the party does not report this round."""
        raise NotImplementedError

    def sample_train_time(self, pid: str, arrival_offset: float) -> float:
        """The training time implied by an arrival (predictor feedback)."""
        raise NotImplementedError


class MeasuredArrivals(ArrivalSource):
    """Replays *measured* per-party ``(train_s, comm_s)`` pairs, one dict
    per round; the arrival offset is their sum and the exact train time is
    fed back to the predictor (no lossy round-tripping through offsets).

    Rounds can be supplied up front (offline replay, ``replay_measured``)
    or pushed incrementally as real training produces them
    (``FLJobRuntime`` with gated engine rounds). A party absent from a
    round's dict simply does not report that round.
    """

    def __init__(self, rounds: Optional[
            List[Dict[str, Tuple[float, float]]]] = None):
        self._rounds: List[Dict[str, Tuple[float, float]]] = [
            dict(r) for r in (rounds or [])
        ]
        self._cur: Dict[str, Tuple[float, float]] = {}

    @property
    def n_rounds(self) -> int:
        return len(self._rounds)

    def push_round(self, measured: Dict[str, Tuple[float, float]]) -> None:
        """Append one round of measured (train_s, comm_s) per party."""
        self._rounds.append(dict(measured))

    def start_round(self, round_idx: int) -> None:
        if round_idx >= len(self._rounds):
            raise IndexError(
                f"no measured arrivals for round {round_idx} "
                f"(have {len(self._rounds)}); push_round() before the "
                f"engine starts it")
        self._cur = self._rounds[round_idx]

    def sample_arrival(self, pid: str) -> Optional[float]:
        rec = self._cur.get(pid)
        if rec is None:
            return None
        train, comm = rec
        return train + comm

    def sample_train_time(self, pid: str, arrival_offset: float) -> float:
        return self._cur[pid][0]


# --------------------------------------------------------------------------
# party arrival emulation (§6.3)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ArrivalModel(ArrivalSource):
    """Samples actual (train, comm) times per party per round.

    Active parties: gaussian noise around their true periodic time.
    Intermittent parties: update at a uniformly random time in [0, t_wait]
    (the paper's random update scheme).
    """

    job: FLJobSpec
    noise_rel: float = 0.02
    seed: int = 0
    dropout_prob: float = 0.0  # per-round no-show probability (§2.2)
    # opt-in presence signal: dropouts are announced at round start instead
    # of being discovered at the §4.3 window close (fleet-parity semantics)
    announce_dropouts: bool = False

    def __post_init__(self):
        self.announces_presence = self.announce_dropouts
        if self.dropout_prob and not self.announce_dropouts:
            # silent dropouts are only discovered at the window close, so
            # a window must exist; announced no-shows shrink the round
            # target at round start and need none
            assert self.job.t_wait_s, \
                "dropout needs a t_wait window to close rounds (§4.3)"
        self.rng = np.random.default_rng(self.seed)
        # ground-truth per-party train time: spec timing is the mean
        self.true_train: Dict[str, float] = {}
        for pid, p in self.job.parties.items():
            if p.mode == "intermittent":
                continue
            if p.epoch_time_s is not None:
                self.true_train[pid] = p.epoch_time_s
            elif p.minibatch_time_s is not None:
                n_mb = max(1, p.dataset_size // max(p.batch_size, 1))
                self.true_train[pid] = p.minibatch_time_s * n_mb
            else:
                from repro_torch.core.prediction import DEFAULT_HARDWARE_THROUGHPUT

                thr = DEFAULT_HARDWARE_THROUGHPUT[p.hardware] * p.n_accelerators
                self.true_train[pid] = p.dataset_size / thr

    def sample_arrival(self, pid: str) -> Optional[float]:
        """Offset of the update arrival from the round start, or None when
        the party drops out this round (never reports before t_wait)."""
        if self.dropout_prob and self.rng.uniform() < self.dropout_prob:
            return None
        p = self.job.parties[pid]
        m = self.job.model_bytes
        comm = m / p.bw_down + m / p.bw_up
        if p.mode == "intermittent":
            assert self.job.t_wait_s
            return float(self.rng.uniform(0.0, self.job.t_wait_s - comm)) + comm
        t = self.true_train[pid]
        t = max(t * (1.0 + self.rng.normal(0.0, self.noise_rel)), 1e-6)
        return t + comm

    def sample_train_time(self, pid: str, arrival_offset: float) -> float:
        """The training time implied by an arrival (for predictor feedback)."""
        p = self.job.parties[pid]
        m = self.job.model_bytes
        return arrival_offset - (m / p.bw_down + m / p.bw_up)


# --------------------------------------------------------------------------
# round engine: the strategy-independent mechanics
# --------------------------------------------------------------------------
class RoundEngine:
    """Runs one job under one deployment strategy; collects JobMetrics.

    The engine owns arrival scheduling, the t_wait round window + quorum
    accounting, the serverless-task and streaming-container execution
    vehicles, and round/job completion. The *when to deploy* decisions are
    delegated to the ``AggregationStrategy`` resolved from
    ``policy.strategy`` (see ``repro.core.policy``).
    """

    def __init__(
        self,
        sim: Simulator,
        cluster: Cluster,
        job: FLJobSpec,
        estimator: AggregationEstimator,
        policy: Union[PolicyConfig, str],
        *,
        arrival_model: Optional[ArrivalSource] = None,
        on_job_done: Optional[Callable[[], None]] = None,
        on_round_complete: Optional[Callable[[int, float], None]] = None,
        external_arrivals: bool = False,  # updates injected via inject_update
        gated_rounds: bool = False,  # next round waits for release_round()
        single_worker_fuse: bool = False,  # w_u = raw t_pair (real runtime)
        class_rank: int = 0,  # SLA-class rank for pool tasks (repro.online)
    ):
        policy = as_policy(policy)
        job.validate()
        self.sim, self.cluster, self.job = sim, cluster, job
        # sim-time tracer (repro.obs) — shared with the cluster, emission
        # guarded on ``enabled`` (free when disabled)
        self.tracer = cluster.tracer
        self.est = estimator
        self.policy = policy
        self.strategy = policy.strategy  # name, for metrics / back-compat
        self.arrivals = arrival_model or ArrivalModel(job)
        self.on_job_done = on_job_done
        self.on_round_complete = on_round_complete
        self.external_arrivals = external_arrivals
        self.gated_rounds = gated_rounds
        self.single_worker_fuse = single_worker_fuse
        self.class_rank = class_rank
        self._release_pending = False
        self._round_waiting = None  # continuation when gated
        self.predictor = UpdatePredictor(job)
        self.metrics = JobMetrics(job.job_id, policy.strategy)
        self._refresh_fuse_cost()
        self.bcast_comm = job.model_bytes / estimator.resources.intra_dc_bw
        cc = self.cluster.cfg
        self.oh_startup = cc.deploy_overhead_s + cc.state_load_s
        self.oh_cycle = self.oh_startup + cc.checkpoint_s  # redeploy cost
        # the pluggable deployment policy (raises on unknown names)
        self.impl: AggregationStrategy = get_strategy(policy.strategy)(
            self, policy)
        # state
        self.round = 0
        self._reset_round_state()

    # ---- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.impl.on_job_start()
        self._start_round()

    def _refresh_fuse_cost(self) -> None:
        """Per-update fuse work on one deployment, re-read every round so
        online estimator calibration (the "fixed" replay policy) is
        reflected. Simulation default: t_pair scaled by usable cores x
        aggregator count (paper §5.4); the real runtime's streaming
        aggregator is a single worker, so w_u = raw t_pair."""
        t_pair = self.est.t_pair_for(self.job.model_bytes)
        if self.single_worker_fuse:
            self.w_u = t_pair
        else:
            res = self.est.resources
            self.w_u = t_pair / (
                usable_cores(res, self.job.model_bytes) * res.n_aggregators
            )

    def _reset_round_state(self):
        self.pending: List[float] = []  # arrival times not yet aggregated
        self.processed = 0
        self.arrived = 0
        self.arrived_parties: Set[str] = set()
        self.no_show_parties: Set[str] = set()  # announced no-shows (§2.2)
        self.task_active = False
        self.last_arrival: Optional[float] = None
        self.round_start = self.sim.now
        self.inflight = 0  # updates handed to a running task
        # streaming container (engine-owned execution vehicle)
        self.stream_deployed = False
        self.stream_busy_until: Optional[float] = None
        self.stream_start_t: Optional[float] = None
        self._close_timer = None
        # reduced by announced no-shows and at window close
        self.round_target = self.job.n_parties
        self._quorum_noted = False  # below-quorum round counted once
        self.round_deploy_t: Optional[float] = None  # first deploy this round
        self.impl.on_round_reset()

    def _start_round(self) -> None:
        self._reset_round_state()
        self._refresh_fuse_cost()
        self.round_start = self.sim.now
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "engine", "round_open", self.job.job_id,
                     round=self.round, strategy=self.strategy,
                     round_target=self.round_target)
        self.arrivals.start_round(self.round)
        # schedule this round's update arrivals (unless driven externally,
        # e.g. by edge-tier aggregators in the hierarchical topology)
        if not self.external_arrivals:
            for pid in self.job.parties:
                off = self.arrivals.sample_arrival(pid)
                if off is None:  # party drops out this round (§2.2)
                    if self.arrivals.announces_presence:
                        self.announce_no_show(pid)
                    continue
                self.sim.schedule(
                    off, lambda pid=pid, off=off: self._on_update(pid, off))
        # §4.3/§5.1: updates past t_wait are ignored; the round closes at the
        # window boundary with whatever arrived, provided quorum is met
        if self.job.t_wait_s:
            self._close_timer = self.sim.schedule(
                float(self.job.t_wait_s), self._close_round_window)
        self.impl.on_round_start()
        if self.round_target <= 0:
            # every party announced a no-show: a failed round (§5.1), the
            # same immediate close the scheduler vehicle's party_no_show
            # path performs when an entire round drops out
            self._note_quorum_failure()
            self._round_complete()

    # ---- update arrival --------------------------------------------------------
    def _on_update(self, pid: str, offset: float) -> None:
        now = self.sim.now
        self.arrived += 1
        self.arrived_parties.add(pid)
        self.last_arrival = now
        self.pending.append(now)
        self.metrics.updates_received += 1
        # predictor feedback (JIT uses it; harmless for others)
        train_t = self.arrivals.sample_train_time(pid, offset)
        self.predictor.observe_round(pid, train_t)
        self.impl.on_update()

    def all_arrived(self) -> bool:
        return self.arrived >= self.round_target

    def announce_no_show(self, pid: str) -> None:
        """§2.2 presence signal: `pid` declares at round start that it will
        skip this round — one fewer arrival to wait for, mirroring
        ``JITScheduler.party_no_show`` so baseline strategies hold the same
        knowledge as the scheduler vehicle."""
        self.no_show_parties.add(pid)
        self.round_target -= 1
        self.metrics.dropped_updates += 1

    def _note_quorum_failure(self) -> None:
        """Record this round as below quorum (§5.1), at most once."""
        if not self._quorum_noted:
            self._quorum_noted = True
            self.metrics.quorum_failures += 1

    def _close_round_window(self) -> None:
        """t_wait reached: ignore missing parties (§4.3); aggregate what
        arrived if quorum holds, else record a failed round (§5.1).
        Announced no-shows already left ``round_target``, so only silent
        late/absent parties are dropped here."""
        self._close_timer = None
        missing = self.round_target - self.arrived
        if missing <= 0:
            return
        self.metrics.dropped_updates += missing
        if self.arrived < self.job.quorum:
            self._note_quorum_failure()
            self.round_target = self.arrived  # close with what we have
            if self.arrived == 0:
                self._round_complete()
                return
        self.round_target = self.arrived
        if self.processed >= self.round_target and self.inflight == 0:
            self._round_complete()
            return
        # kick the strategy to drain the remainder now
        self.impl.on_window_close()

    # ---- execution vehicles (the engine-callback surface) ---------------------
    def take_pending(self) -> int:
        """Claim every queued update for processing; returns the count."""
        k = len(self.pending)
        if k:
            self.pending.clear()
            self.inflight += k
        return k

    def submit_batch(self, k: int) -> None:
        """Run k pending updates as one serverless aggregation task."""
        if k <= 0:
            return
        del self.pending[:k]
        self.inflight += k
        self.task_active = True
        if self.round_deploy_t is None:
            self.round_deploy_t = self.sim.now
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "engine", "drain_submit",
                     self.job.job_id, round=self.round, k=k,
                     work_s=k * self.w_u, strategy=self.strategy)
        self.cluster.submit(
            self.job.job_id,
            priority=self.sim.now,  # FIFO among serverless tasks
            work_s=k * self.w_u,
            on_complete=lambda t, k=k: self.task_done(k, t),
            preemptible=False,
            class_rank=self.class_rank,
        )

    def stream_deploy(self) -> None:
        """Deploy the streaming container (no-op if live or work is done)."""
        if self.stream_deployed or self.processed + self.inflight >= self.round_target:
            return
        self.stream_deployed = True
        if self.round_deploy_t is None:
            self.round_deploy_t = self.sim.now
        self.cluster.record_deploy(self.job.job_id)
        self.cluster.note_container(self.sim.now, +1)
        self.metrics.jit_deploys += 1
        tr = self.tracer
        if tr.enabled:
            tr.event(self.sim.now, "engine", "stream_deploy",
                     self.job.job_id, round=self.round,
                     pending=len(self.pending), strategy=self.strategy)
        self.stream_start_t = self.sim.now
        self.stream_busy_until = self.sim.now + self.oh_startup
        self.stream_feed()

    def stream_feed(self) -> None:
        """Feed every pending update into the live streaming container."""
        k = self.take_pending()
        if k == 0:
            return
        start = max(self.sim.now, self.stream_busy_until)
        self.stream_busy_until = start + k * self.w_u
        self.sim.schedule_at(
            self.stream_busy_until, lambda k=k: self.task_done(k, self.sim.now)
        )

    def stream_release(self) -> float:
        """Checkpoint partial aggregate + release the container; returns the
        time at which the container is actually gone (after checkpoint)."""
        end = self.sim.now + self.cluster.cfg.checkpoint_s
        start = self.stream_start_t if self.stream_start_t is not None else end
        dur = end - start
        self.cluster.note_container(end, -1)
        self.cluster.container_seconds += dur
        self.cluster.container_seconds_by_job[self.job.job_id] = (
            self.cluster.container_seconds_by_job.get(self.job.job_id, 0.0) + dur
        )
        # the span carries the exact billed endpoints (start → end-of-
        # checkpoint), so traced totals reconcile with the ledger exactly
        tr = self.tracer
        if tr.enabled:
            tr.span(start, end, "container", "stream",
                    job_id=self.job.job_id, round=self.round,
                    strategy=self.strategy)
        self.stream_deployed = False
        self.stream_start_t = None
        return end

    def expected_remaining_makespan(self):
        """(R, k): expected time until the round's last update arrives, and
        the number of updates still outstanding (keep-alive economics)."""
        now = self.sim.now
        k = 0
        R = 0.0
        max_tupd = 0.0
        for pid, p in self.job.parties.items():
            if pid in self.arrived_parties or pid in self.no_show_parties:
                continue
            k += 1
            if p.mode == "intermittent":
                t_end = self.round_start + float(self.job.t_wait_s)
                R = max(R, max(t_end - now, 0.0))
            else:
                t_upd = self.predictor.t_upd(pid)
                max_tupd = max(max_tupd, t_upd)
                R = max(R, self.round_start + t_upd - now)
        if max_tupd:
            # overdue parties (eta<=0) are late by an unknown amount on the
            # prediction-noise scale — never report a zero makespan
            R = max(R, 0.02 * max_tupd)
        return R, k

    # ---- completion --------------------------------------------------------------
    def task_done(self, k: int, t: float):
        """Completion callback for both execution vehicles."""
        self.processed += k
        self.inflight -= k
        self.task_active = False
        if self.processed >= self.round_target:
            self._round_complete()
            return
        self.impl.on_task_done()

    def _round_complete(self):
        done = self.impl.finish_round()
        tr = self.tracer
        if tr.enabled:
            tr.event(done, "engine", "round_close", self.job.job_id,
                     round=self.round, strategy=self.strategy,
                     arrived=self.arrived, processed=self.processed,
                     round_target=self.round_target)
        if self.last_arrival is not None:
            # §6.2 latency is measured from the true last arrival; a round
            # with zero arrivals contributes none (scheduler-vehicle parity)
            self.metrics.round_latencies.append(
                aggregation_latency(done, self.last_arrival))
        if self.arrived < self.job.quorum:
            self._note_quorum_failure()
        # §5.5 SLA lateness against this round's prediction, when the
        # policy produced one (same definition as the scheduler vehicle);
        # a zero-arrival (failed) round contributes no sample, like the
        # scheduler vehicle's all-dropout path — a bogus -t_rnd entry
        # would pool into the fleet lateness percentiles as "early"
        if self.arrived > 0 and \
                len(self.metrics.predictions) > len(self.metrics.round_lateness):
            self.metrics.round_lateness.append(sla_lateness(
                done, self.round_start, self.metrics.predictions[-1][0]))
        self.metrics.rounds_done += 1
        completed = self.round
        self.round += 1
        self.impl.on_round_end()
        if self._close_timer is not None:
            self._close_timer.cancel()
            self._close_timer = None
        if self.on_round_complete:
            self.on_round_complete(completed, done)

        def next_round():
            if self.round < self.job.rounds:
                if self.gated_rounds and not self._release_pending:
                    self._round_waiting = self._start_round  # wait for release
                else:
                    self._release_pending = False
                    self._start_round()
            else:
                self._job_done()

        if self.job.has_intermittent():
            # fixed round windows: next round starts at t_wait boundary
            nxt = self.round_start + float(self.job.t_wait_s)
            self.sim.schedule_at(max(nxt, done), next_round)
        else:
            # active parties: next round after the fused model is broadcast
            self.sim.schedule_at(done + self.bcast_comm, next_round)

    # ---- hierarchical-topology hooks ------------------------------------------
    def inject_update(self, pid: str) -> None:
        """Deliver an externally-produced update (edge partial aggregate)."""
        assert self.external_arrivals
        self._on_update(pid, self.sim.now - self.round_start)

    def release_round(self) -> None:
        """Unblock the next gated round (e.g. global model broadcast)."""
        if self._round_waiting is not None:
            cont, self._round_waiting = self._round_waiting, None
            cont()
        else:
            self._release_pending = True

    def billed_metrics(self, price: float) -> JobMetrics:
        """This job's metrics with billing read live from the cluster, so
        runs stopped early report what was actually billed (identical to
        the engine's own value once the job completes). The one builder
        for ``Platform.metrics`` and ``FleetRunner.metrics``.

        Containers that bill only at release — the always-on aggregator
        and a live streaming container — contribute their accrued-so-far
        time too, so a partially-drained run never reports a job as free
        while its dedicated container has been alive for hours."""
        m = self.metrics
        m.n_deploys = self.cluster.n_deploys_by_job.get(self.job.job_id, 0)
        live = self.impl.accrued_container_seconds()
        if self.stream_deployed and self.stream_start_t is not None:
            live += self.sim.now - self.stream_start_t
        m.container_seconds = self.cluster.container_seconds_by_job.get(
            self.job.job_id, 0.0) + live
        m.cost_usd = m.container_seconds * price
        return m

    def _job_done(self):
        self.impl.on_job_end()
        self.metrics.finished_at = self.sim.now
        self.metrics.container_seconds = self.cluster.container_seconds_by_job.get(
            self.job.job_id, 0.0
        )
        if self.on_job_done:
            self.on_job_done()


# --------------------------------------------------------------------------
# the built-in deployment strategies (§3) as registry plugins
# --------------------------------------------------------------------------
@register_strategy("eager_ao")
class EagerAO(AggregationStrategy):
    """Always-on aggregator: billed from job start to job end (§3)."""

    def __init__(self, engine, policy):
        super().__init__(engine, policy)
        self.ao: Optional[AlwaysOnContainer] = None

    def on_job_start(self):
        self.ao = AlwaysOnContainer(self.engine.cluster, self.engine.job.job_id)

    def on_update(self):
        self._process()

    def on_window_close(self):
        self._process()

    def finish_round(self) -> float:
        return self.engine.sim.now  # state stays in memory; no checkpoint

    def on_job_end(self):
        if self.ao is not None:
            self.ao.shutdown()
            self.ao = None

    def accrued_container_seconds(self) -> float:
        if self.ao is None:
            return 0.0  # shut down: everything billed to the cluster
        return self.engine.sim.now - self.ao.start_t

    def _process(self):
        e = self.engine
        k = e.take_pending()
        if k:
            self.ao.process(k * e.w_u, lambda t, k=k: e.task_done(k, t))


class _ServerlessDrain(AggregationStrategy):
    """Shared t_wait drain for the serverless-task strategies."""

    def on_window_close(self):
        e = self.engine
        if not e.task_active and e.pending:
            e.submit_batch(len(e.pending))


@register_strategy("eager_serverless")
class EagerServerless(_ServerlessDrain):
    """Deploy an aggregator dynamically per arriving update (Eager-λ, §3);
    a busy aggregator serialises followers (bounded per invocation)."""

    def _cap(self) -> int:
        return min(len(self.engine.pending),
                   self.policy.eager_max_per_invocation)

    def on_update(self):
        if not self.engine.task_active:
            self.engine.submit_batch(self._cap())

    def on_task_done(self):
        if self.engine.pending:
            self.engine.submit_batch(self._cap())


@register_strategy("batched")
class Batched(_ServerlessDrain):
    """Deploy per batch of ``batch_trigger`` updates (Batched-λ, §3)."""

    def on_update(self):
        e = self.engine
        if len(e.pending) >= self.policy.batch_trigger or e.all_arrived():
            e.submit_batch(len(e.pending))

    def on_task_done(self):
        e = self.engine
        if e.pending:
            e.submit_batch(len(e.pending))


@register_strategy("lazy")
class Lazy(_ServerlessDrain):
    """Deploy once, after the last update arrives (§3)."""

    def on_update(self):
        e = self.engine
        if e.all_arrived():
            e.submit_batch(len(e.pending))


@register_strategy("jit")
class JIT(AggregationStrategy):
    """Deploy at predicted t_rnd − t_agg: timer + priority + keep-alive
    economics (§5.5), with the beyond-paper ``orderstat`` refinements."""

    def on_round_reset(self):
        self.armed = False  # past the deadline / all-arrived trigger
        self._timer = None
        self._t_rnd_exp = 0.0
        self._trigger_abs = 0.0
        self.priority = 0.0

    def on_round_start(self):
        """Plan the deployment from predictions (Fig. 6)."""
        e = self.engine
        t_rnd_sla = e.predictor.t_rnd()  # Fig. 6 lines 6-11
        t_agg = e.est.t_agg(e.job)  # Fig. 6 line 13
        if self.policy.jit_policy == "fixed":
            # deterministic replay timeline: deploy exactly at t_rnd − t_agg
            # (startup overhead spent after the trigger, as the real
            # runtime's virtual timeline always priced it)
            trigger = max(0.0, t_rnd_sla - t_agg)
        else:
            self._t_rnd_exp = self._expected_t_rnd()
            trigger = max(0.0, t_rnd_sla - t_agg - e.oh_startup)
        e.metrics.predictions.append((t_rnd_sla, t_agg))
        self.priority = e.round_start + trigger  # §5.5 priority
        self._trigger_abs = e.round_start + trigger
        tr = e.tracer
        if tr.enabled:
            # the per-round strategy decision: where JIT planted its trigger
            tr.event(e.sim.now, "engine", "jit_plan", e.job.job_id,
                     round=e.round, t_rnd=t_rnd_sla, t_agg=t_agg,
                     trigger_abs=self._trigger_abs,
                     jit_policy=self.policy.jit_policy)
        self._timer = e.sim.schedule(trigger, self._timer_fire)

    # ---- prediction of the round end ------------------------------------
    def _expected_t_rnd(self) -> float:
        """Expected last-arrival offset under the active policy."""
        e = self.engine
        if self.policy.jit_policy == "paper" or not e.job.has_intermittent():
            # Fig. 6 lines 6-11 (for intermittent parties t_train = t_wait).
            return e.predictor.t_rnd()
        # order-statistic estimate for the intermittent max (see module
        # docstring), plus the margin_sigmas safety margin
        ints = [p for p in e.job.parties.values() if p.mode == "intermittent"]
        acts = [
            e.predictor.t_upd(p.party_id)
            for p in e.job.parties.values()
            if p.mode != "intermittent"
        ]
        k = len(ints)
        m = e.job.model_bytes
        comm = max(m / p.bw_down + m / p.bw_up for p in ints)
        span = max(float(e.job.t_wait_s) - comm, 0.0)
        mean_max = comm + span * k / (k + 1)
        if self.policy.margin_sigmas:
            # std of the max of k uniforms on [comm, comm+span]; push the
            # estimate later for noise robustness, never past the window
            sigma = span * math.sqrt(k / ((k + 1) ** 2 * (k + 2)))
            mean_max = min(mean_max + self.policy.margin_sigmas * sigma,
                           comm + span)
        return max(mean_max, max(acts) if acts else 0.0)

    def _backlog_fill(self) -> bool:
        """True when the queued fuse work fills the time left to t_rnd_exp:
        deploying now finishes the drain just as the last update lands."""
        e = self.engine
        left = e.round_start + self._t_rnd_exp - e.sim.now
        return left <= e.oh_startup + len(e.pending) * e.w_u

    # ---- engine hooks ----------------------------------------------------
    def on_update(self):
        e = self.engine
        if e.stream_deployed:
            e.stream_feed()
            return
        if self.policy.jit_policy == "fixed":
            return  # deterministic timeline: wait for the planned trigger
        if e.all_arrived():
            # nothing left to wait for: trigger now
            self._arm()
            return
        if self.armed:
            # tail update after the deadline drain released the container
            e.stream_deploy()
            return
        if self.policy.jit_policy == "orderstat" and self._backlog_fill():
            self._arm()
            return
        if self.policy.opportunistic and e.cluster.idle_capacity() > 0:
            # greedy early drain when pending work amortises a deployment
            if len(e.pending) * e.w_u >= self.policy.amort_factor * e.oh_cycle:
                e.metrics.jit_early_drains += 1
                e.stream_deploy()

    def on_window_close(self):
        e = self.engine
        if e.stream_deployed:
            e.stream_feed()
        else:
            self._arm()

    def on_task_done(self):
        e = self.engine
        if e.stream_deployed:
            if e.pending:
                e.stream_feed()
            else:
                self._on_dry()

    def on_round_end(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    # ---- internals -------------------------------------------------------
    def _timer_fire(self):
        """Deadline reached (Fig. 6 line 19-21), work-conserving per §5.5."""
        e = self.engine
        if self.armed or e.stream_deployed:
            return
        if self.policy.jit_policy == "fixed" or e.pending:
            self._arm()
        else:
            # no pending updates: defer, retaining the priority (§5.5)
            self._timer = e.sim.schedule(
                e.cluster.cfg.delta_s, self._timer_fire
            )

    def _arm(self):
        """Point of no return: from here updates are handled eagerly."""
        self.armed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self.engine.stream_deployed:
            self.engine.stream_deploy()

    def _on_dry(self):
        """Stream drained but more updates are expected: keep-alive policy.

        Economics: staying hot until the round ends costs the expected
        remaining makespan R in idle container-seconds; releasing costs up
        to one checkpoint+redeploy cycle per remaining straggler. Stay hot
        iff R <= keepalive_factor * k * oh_cycle."""
        e = self.engine
        if e.inflight > 0:
            return  # later feeds still running: the stream is not dry yet
        if self.policy.jit_policy == "fixed":
            return  # deterministic timeline: hot from trigger to completion
        R, k = e.expected_remaining_makespan()
        if k > 0 and R <= self.policy.keepalive_factor * k * e.oh_cycle:
            return  # cheaper to idle hot than to checkpoint + redeploy
        e.stream_release()

    def finish_round(self) -> float:
        done = super().finish_round()
        if self.policy.jit_policy == "fixed":
            # the real runtime's online §5.4 feedback loop: refit t_pair
            # from the observed drain (completion − max(trigger, last
            # arrival)), visible to the next round's t_agg and w_u
            e = self.engine
            last = (self._trigger_abs if e.last_arrival is None
                    else e.last_arrival)
            tr = e.tracer
            if not tr.enabled:
                e.est.calibrate(done - max(self._trigger_abs, last),
                                e.job, max(e.processed, 1))
            else:
                before = e.est.t_pair_for(e.job.model_bytes)
                e.est.calibrate(done - max(self._trigger_abs, last),
                                e.job, max(e.processed, 1))
                tr.event(done, "calibration", "t_pair", e.job.job_id,
                         round=e.round,
                         observed_t_agg_s=done - max(self._trigger_abs,
                                                     last),
                         n_updates=max(e.processed, 1),
                         t_pair_before=before,
                         t_pair_after=e.est.t_pair_for(e.job.model_bytes),
                         t_agg_after=e.est.t_agg(e.job),
                         source=("cost_table" if e.est.cost_table is not None
                                 else "constant"))
        return done


# Derived from the registry (built-ins register above, in §3 order). This
# is an import-time snapshot of the built-ins: strategies registered later
# (plugins) are resolvable by name everywhere but only appear in
# available_strategies(), which reads the live registry.
STRATEGIES = available_strategies()


# --------------------------------------------------------------------------
# backward-compatible shims over the pre-registry API
# --------------------------------------------------------------------------
def StrategyRun(
    sim: Simulator,
    cluster: Cluster,
    job: FLJobSpec,
    estimator: AggregationEstimator,
    strategy: str,
    *,
    batch_trigger: int = 10,
    arrival_model: Optional[ArrivalModel] = None,
    opportunistic: bool = False,
    on_job_done: Optional[Callable[[], None]] = None,
    on_round_complete: Optional[Callable[[int, float], None]] = None,
    external_arrivals: bool = False,
    gated_rounds: bool = False,
    jit_policy: str = "orderstat",
    margin_sigmas: float = 0.0,
    keepalive_factor: float = 1.0,
    amort_factor: float = 4.0,
    eager_max_per_invocation: int = 32,
) -> RoundEngine:
    """Deprecated: constructor-compatible shim over ``RoundEngine``.

    Prefer ``RoundEngine(sim, cluster, job, estimator, PolicyConfig(...))``
    or the ``repro.api.Platform`` facade.
    """
    policy = PolicyConfig(
        strategy=strategy,
        batch_trigger=batch_trigger,
        jit_policy=jit_policy,
        margin_sigmas=margin_sigmas,
        keepalive_factor=keepalive_factor,
        amort_factor=amort_factor,
        eager_max_per_invocation=eager_max_per_invocation,
        opportunistic=opportunistic,
    )
    return RoundEngine(
        sim, cluster, job, estimator, policy,
        arrival_model=arrival_model,
        on_job_done=on_job_done,
        on_round_complete=on_round_complete,
        external_arrivals=external_arrivals,
        gated_rounds=gated_rounds,
    )


def run_strategy(
    job: FLJobSpec,
    strategy: str,
    *,
    t_pair_s: float = 0.05,
    cluster_config: Optional[ClusterConfig] = None,
    estimator: Optional[AggregationEstimator] = None,
    batch_trigger: int = 10,
    seed: int = 0,
    noise_rel: float = 0.02,
    dropout_prob: float = 0.0,
    opportunistic: bool = False,
    jit_policy: str = "orderstat",
    margin_sigmas: float = 0.0,
    keepalive_factor: float = 1.0,
    amort_factor: float = 4.0,
    eager_max_per_invocation: int = 32,
) -> JobMetrics:
    """Run one job end-to-end under a strategy (pre-``Platform`` shim).

    Thin wrapper over ``repro.api.run_job``; kept for backward
    compatibility. Note: ``margin_sigmas`` now actually feeds the orderstat
    t_rnd safety margin; its default is 0 (the former default of 2.0 was
    stored but never read, i.e. behaved as 0).
    """
    from repro_torch.api import run_job

    policy = PolicyConfig(
        strategy=strategy,
        batch_trigger=batch_trigger,
        jit_policy=jit_policy,
        margin_sigmas=margin_sigmas,
        keepalive_factor=keepalive_factor,
        amort_factor=amort_factor,
        eager_max_per_invocation=eager_max_per_invocation,
        opportunistic=opportunistic,
    )
    return run_job(
        job, policy,
        cluster_config=cluster_config,
        estimator=estimator,
        t_pair_s=t_pair_s,
        seed=seed,
        noise_rel=noise_rel,
        dropout_prob=dropout_prob,
    )
