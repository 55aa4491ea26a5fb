"""The port's single-job simulation and multi-job Fig. 6 JIT scheduler
against the JAX package's: the same job specs and seeds go through
``repro.api`` and ``repro_torch.api`` (and the two ``JITScheduler``s), and
every result must be equal with ``==``. Both packages run the same Python
and numpy float operations in the same order, so a difference is a fault
of the port's copy."""
import types

import pytest

import repro.api
import repro.core
import repro.core.scheduler
import repro.obs
import repro_torch.api
import repro_torch.core
import repro_torch.core.scheduler
import repro_torch.obs
from _torch_parity import plain

REF = types.SimpleNamespace(api=repro.api, core=repro.core,
                            sched=repro.core.scheduler, obs=repro.obs)
PORT = types.SimpleNamespace(api=repro_torch.api, core=repro_torch.core,
                             sched=repro_torch.core.scheduler,
                             obs=repro_torch.obs)
STRATEGIES = repro.core.STRATEGIES


def _job(P, job_id="j", n=5, rounds=2, epoch_s=50.0, model_mb=10, **kw):
    return P.core.FLJobSpec(
        job_id=job_id, model_arch="x", model_bytes=model_mb << 20,
        rounds=rounds, **kw,
        parties={f"{job_id}-p{i}": P.core.PartySpec(
            f"{job_id}-p{i}", epoch_time_s=epoch_s * (1.0 + 0.1 * i))
            for i in range(n)},
    )


def test_the_registries_match():
    assert repro_torch.core.STRATEGIES == STRATEGIES
    assert (repro_torch.core.available_strategies()
            == repro.core.available_strategies())


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_job_matches_reference(strategy):
    def run(P):
        return plain(P.api.run_job(_job(P, t_wait_s=120.0), strategy,
                                   seed=3, dropout_prob=0.1))
    port = run(PORT)
    assert port["rounds_done"] == 2
    assert port == run(REF)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_strategy_matches_reference(strategy):
    def run(P):
        return plain(P.core.run_strategy(
            _job(P), strategy, t_pair_s=0.2, seed=1, noise_rel=0.05,
            opportunistic=True))
    assert run(PORT) == run(REF)


@pytest.mark.parametrize("policy", [
    dict(strategy="jit", jit_policy="fixed"),
    dict(strategy="jit", opportunistic=True, margin_sigmas=1.0),
    dict(strategy="batched", batch_trigger=2),
    dict(strategy="eager_serverless", eager_max_per_invocation=2),
])
def test_submit_with_policy_configs_matches_reference(policy):
    """Two jobs submitted to one Platform contend for its cluster."""
    def run(P):
        platform = P.api.Platform(P.core.ClusterConfig(capacity=1),
                                  t_pair_s=0.5)
        for job_id in ("a", "b"):
            platform.submit(_job(P, job_id, rounds=3),
                            P.core.PolicyConfig(**policy), seed=7)
        out = platform.run()
        return plain(out), platform.cluster.n_preemptions
    assert run(PORT) == run(REF)


def test_submit_scheduled_two_contending_jobs_match_reference():
    """§5.5 contention on one container: a long job and a tight-deadline
    one, deadline priorities, preemption. Per-job metrics, lateness,
    predictions, preemptions and the billed ledger must all agree."""
    def run(P):
        platform = P.api.Platform(P.core.ClusterConfig(capacity=1),
                                  t_pair_s=5.0)
        long_ = platform.submit_scheduled(
            _job(P, "long", n=40, rounds=2, epoch_s=2000.0))
        fast = platform.submit_scheduled(
            _job(P, "fast", n=4, rounds=3, epoch_s=10.0))
        metrics = platform.run()
        c = platform.cluster
        return (plain(metrics),
                [plain(st.lateness) + plain(st.predictions)
                 for st in (long_, fast)],
                c.n_preemptions, dict(c.n_preemptions_by_job),
                dict(c.container_seconds_by_job), c.occupancy_events)
    port = run(PORT)
    assert port[0]["fast"]["rounds_done"] == 3
    assert port[0]["long"]["rounds_done"] == 2
    assert port == run(REF)


@pytest.mark.parametrize("priority_policy", ["deadline", "fifo"])
def test_scheduler_priorities_match_reference(priority_policy):
    def run(P):
        platform = P.api.Platform(P.core.ClusterConfig(capacity=2),
                                  t_pair_s=1.0)
        platform.scheduler(priority_policy=priority_policy, round_gap_s=2.0)
        for k in range(5):
            platform.submit_scheduled(_job(P, f"j{k}", n=6, rounds=2,
                                           epoch_s=30.0 + 20.0 * k))
        return plain(platform.run()), platform.cluster.n_preemptions
    assert run(PORT) == run(REF)


def _gated_round(P, events):
    """One arrival-gated round of a 4-party job (quorum 3) on a bare
    JITScheduler, driven by (t, party or None for a no-show) events."""
    sim = P.core.Simulator()
    cluster = P.core.Cluster(sim, P.core.ClusterConfig(capacity=4,
                                                       delta_s=0.5))
    est = P.core.AggregationEstimator(t_pair_s=0.5)
    done = []
    sched = P.sched.JITScheduler(
        sim, cluster, est, on_aggregated=lambda j, r, t: done.append((j, r, t)))
    job = P.core.FLJobSpec(
        "g", "x", 10 << 20, quorum_fraction=0.75,
        parties={f"p{i}": P.core.PartySpec(f"p{i}", epoch_time_s=100.0)
                 for i in range(4)})
    st = sched.upon_arrival(job, gated=True)
    sched.start_round("g")
    for t, pid in events:
        if pid is None:
            sim.schedule_at(t, lambda: sched.party_no_show("g"))
        else:
            sim.schedule_at(t, lambda p=pid, tt=t: sched.deliver_update(
                "g", p, tt - 1.0))
    sim.run()
    m = st.to_metrics(cluster, price=1.0)
    return plain(m), st.deadline, st.quorum_failures, st.no_shows, done


@pytest.mark.parametrize("events", [
    [(50.0, "p0"), (60.0, "p1"), (70.0, None), (75.0, None)],
    [(50.0, "p0"), (400.0, "p1"), (410.0, "p2"), (420.0, "p3")],
    [(20.0, "p0"), (30.0, "p1"), (40.0, "p2"), (45.0, None)],
], ids=["no-shows", "past-deadline", "last-drops"])
def test_arrival_gated_round_matches_reference(events):
    port = _gated_round(PORT, events)
    assert port[0]["rounds_done"] == 1
    assert port == _gated_round(REF, events)


def test_traced_submit_reconciles_and_matches_reference():
    def run(P):
        tracer = P.obs.Tracer()
        platform = P.api.Platform(P.core.ClusterConfig(capacity=2),
                                  t_pair_s=0.5, tracer=tracer)
        platform.submit(_job(P, "a"), "jit")
        platform.submit_scheduled(_job(P, "b", rounds=3))
        metrics = platform.run()
        assert tracer.reconcile(platform.cluster) == []
        return (plain(metrics), tracer.container_seconds_by_job(),
                [(e.t, e.cat, e.name, e.job_id)
                 for e in tracer.canonical_events()])
    port = run(PORT)
    assert port[2]
    assert port == run(REF)


def test_platform_refuses_what_the_reference_refuses():
    for P in (REF, PORT):
        platform = P.api.Platform()
        platform.submit(_job(P, "a"))
        with pytest.raises(ValueError, match="already submitted"):
            platform.submit_scheduled(_job(P, "a"))
        platform.scheduler(priority_policy="deadline")
        with pytest.raises(ValueError, match="one scheduler per"):
            platform.scheduler(priority_policy="fifo")
        with pytest.raises(ValueError):
            platform.submit(_job(P, "b"), "no-such-strategy")
        platform.run()
        with pytest.raises(RuntimeError, match="already called"):
            platform.run()
        with pytest.raises(RuntimeError, match="already called"):
            platform.submit(_job(P, "c"))
