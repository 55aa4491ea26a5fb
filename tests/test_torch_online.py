"""The port's online control plane (``repro_torch.online``,
``Platform.serve``) against the JAX package's: the same open-loop arrival
stream with SLA classes, admission bursts and pool autoscaling, run to
``drain()``. The ``OnlineReport``, the windows ``poll()`` returns mid-run,
the live ``dashboard()`` and the traced billing must all equal the
reference's with ``==``."""
import math
import types

import pytest

import repro.api
import repro.core
import repro.fleet
import repro.obs
import repro.online
import repro_torch.api
import repro_torch.core
import repro_torch.fleet
import repro_torch.obs
import repro_torch.online
from _torch_parity import plain

REF = types.SimpleNamespace(api=repro.api, core=repro.core, fleet=repro.fleet,
                            obs=repro.obs, online=repro.online)
PORT = types.SimpleNamespace(api=repro_torch.api, core=repro_torch.core,
                             fleet=repro_torch.fleet, obs=repro_torch.obs,
                             online=repro_torch.online)
SLA_CYCLE = ("gold", "silver", "best_effort")


def _serve(P, *, strategy="jit", autoscaled=True, burst=(800.0, 2400.0, 3.0),
           mid_s=2000.0, t_pair_s=2.0, max_capacity=8, traced=True):
    """One open-loop run with the burst knobs of ``benchmarks/online.py``
    (18 mixed jobs, Poisson + diurnal arrivals, 3x burst, the SLA ladder by
    arrival index): (report, mid-run windows, mid-run and final dashboards,
    scale events, reconcile result)."""
    tracer = P.obs.Tracer() if traced else None
    platform = P.api.Platform(
        P.core.ClusterConfig(capacity=2 if autoscaled else max_capacity),
        P.core.AggregationEstimator(t_pair_s=t_pair_s), tracer=tracer)
    stream = P.online.TraceStream(
        P.fleet.synthetic_fleet(18, "mixed", seed=0), timing="poisson",
        mean_interarrival_s=120.0, diurnal_period_s=2400.0,
        diurnal_amplitude=0.3, burst=burst, seed=0)
    auto = (P.online.AutoscalerConfig(min_capacity=1,
                                      max_capacity=max_capacity)
            if autoscaled else P.online.AutoscalerConfig.fixed(max_capacity))
    svc = platform.serve(
        stream, strategy=strategy,
        sla=lambda jt, idx: SLA_CYCLE[idx % len(SLA_CYCLE)],
        autoscaler=auto,
        admission=P.online.AdmissionConfig(burst_window_s=300.0,
                                           burst_arrivals=4),
        window_s=600.0)
    svc.advance(until=mid_s)
    mid = [w.summary() for w in svc.poll()]
    mid_view = svc.dashboard(last_windows=2).as_dict()
    report = svc.drain()
    final_view = svc.dashboard().as_dict()
    rec = tracer.reconcile(platform.cluster) if traced else None
    return {
        "report": plain(report),
        "summary": report.summary(),
        "sla": plain(report.sla_attainment()),
        "mid_windows": mid,
        "mid_view": plain(mid_view),
        "final_view": plain(final_view),
        "scale": (svc.n_scale_ups, svc.n_scale_downs),
        "metrics": plain(platform.metrics()),
        "reconcile": rec,
        "traced": tracer.container_seconds_by_job() if traced else None,
    }


@pytest.mark.parametrize("strategy,autoscaled", [("jit", True),
                                                 ("jit", False),
                                                 ("eager_ao", False)])
def test_serve_burst_matches_reference(strategy, autoscaled):
    port = _serve(PORT, strategy=strategy, autoscaled=autoscaled)
    assert port["reconcile"] == []
    assert port["final_view"]["done"] is True
    assert port["mid_windows"] and port["summary"]["rounds"] > 0
    assert port == _serve(REF, strategy=strategy, autoscaled=autoscaled)


def test_serve_saturated_pool_without_burst_matches_reference():
    """No burst, a pool capped below demand: class-rank priorities and
    preemptions decide who waits."""
    kw = dict(burst=None, t_pair_s=6.0, max_capacity=2)
    port = _serve(PORT, **kw)
    assert sum(c["preemptions"] for c in
               port["summary"]["classes"].values()) > 0
    assert port == _serve(REF, **kw)


def test_serve_untraced_dashboard_has_no_metrics_in_either():
    port = _serve(PORT, traced=False)
    assert port["final_view"]["metrics"] is None
    assert port == _serve(REF, traced=False)


def test_trace_replay_equals_batch_fleet_in_the_port():
    """serve(TraceStream(trace)) with every job gold is arrival-identical to
    submit_fleet(trace): the same rollup, bit for bit."""
    trace = PORT.fleet.synthetic_fleet(6, "steady", seed=3)
    batch = PORT.api.Platform(PORT.core.ClusterConfig(capacity=8))
    runner = batch.submit_fleet(trace)
    batch.run()
    svc = PORT.api.Platform(PORT.core.ClusterConfig(capacity=8)).serve(
        PORT.online.TraceStream(trace), window_s=120.0,
        autoscaler=PORT.online.AutoscalerConfig.fixed(8))
    report = svc.drain()
    assert plain(report.fleet) == plain(runner.result().fleet)


def test_stream_handle_matches_reference():
    """Jobs pushed by hand into a StreamHandle, then closed."""
    def run(P):
        jobs = P.fleet.synthetic_fleet(4, "steady", seed=1).jobs
        handle = P.online.StreamHandle()
        svc = P.api.Platform(P.core.ClusterConfig(capacity=4)).serve(
            handle, sla="silver")
        for k, jt in enumerate(jobs):
            handle.submit(jt, at=50.0 * k)
        svc.advance(until=120.0)
        mid = [w.summary() for w in svc.poll()]
        handle.close()
        return plain(svc.drain()), mid
    port = run(PORT)
    assert port[0]["fleet"]["n_jobs"] == 4
    assert port == run(REF)


def test_sla_ladders_and_configs_match_reference():
    assert plain(PORT.online.SLA_CLASSES) == plain(REF.online.SLA_CLASSES)
    for cfg in ("AdmissionConfig", "AutoscalerConfig"):
        assert (plain(getattr(PORT.online, cfg)())
                == plain(getattr(REF.online, cfg)()))
    for P in (REF, PORT):
        with pytest.raises(ValueError):
            P.online.AutoscalerConfig(min_capacity=3, max_capacity=2)
        assert math.isinf(P.online.SLA_CLASSES["best_effort"]
                          .lateness_p95_band_s)
