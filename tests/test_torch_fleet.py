"""The port's fleet vehicle (``repro_torch.fleet``) against the JAX
package's: synthetic and measured traces through ``submit_fleet`` under
the JIT scheduler and the engine baselines, the philox counter streams and
their vectorized fast path, the JSON-lines trace format in both
directions, and cells of the cross-vehicle conformance matrix. Every result
must equal the reference's with ``==``."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.api
import repro.core
import repro.fleet
import repro.fleet.conformance
import repro.fleet.streams
import repro_torch.api
import repro_torch.core
import repro_torch.fleet
import repro_torch.fleet.conformance
import repro_torch.fleet.streams
from _torch_parity import plain
from repro_torch import configs
from repro_torch.models import model as M

torch.set_num_threads(1)

REF = types.SimpleNamespace(api=repro.api, core=repro.core, fleet=repro.fleet,
                            conf=repro.fleet.conformance,
                            streams=repro.fleet.streams)
PORT = types.SimpleNamespace(api=repro_torch.api, core=repro_torch.core,
                             fleet=repro_torch.fleet,
                             conf=repro_torch.fleet.conformance,
                             streams=repro_torch.fleet.streams)


def _run_fleet(P, trace, strategy, *, capacity=8, t_pair_s=0.05, **kw):
    """(per-job metrics, fleet rollup, the arrivals each party sampled)."""
    log = []
    platform = P.api.Platform(P.core.ClusterConfig(capacity=capacity),
                              P.core.AggregationEstimator(t_pair_s=t_pair_s))
    runner = platform.submit_fleet(
        trace, strategy, recorder=lambda *a: log.append(a), **kw)
    platform.run()
    assert runner.all_done
    res = runner.result()
    return plain(res.jobs), plain(res.fleet), log


@pytest.mark.parametrize("strategy,golden", [("jit", 384.6),
                                             ("eager_ao", 28803.8)])
def test_synthetic_fleet_golden_cell_matches_reference(strategy, golden):
    """The 16-job mixed fleet of the reference's golden savings cell."""
    port = _run_fleet(PORT, PORT.fleet.synthetic_fleet(16), strategy)
    assert round(port[1]["container_seconds"], 1) == golden
    assert port == _run_fleet(REF, REF.fleet.synthetic_fleet(16), strategy)


@pytest.mark.parametrize("strategy", ["jit", "eager_ao", "batched", "lazy"])
@pytest.mark.parametrize("pattern", ["dropout", "intermittent"])
def test_philox_fleets_match_reference(pattern, strategy):
    """rng="philox": counter-stream parties, and for "jit" the vectorized
    fast path of the scheduler (presampled rounds, analytic triggers)."""
    def run(P):
        return _run_fleet(P, P.fleet.synthetic_fleet(6, pattern, seed=5),
                          strategy, rng="philox")
    port = run(PORT)
    if pattern == "dropout":
        assert any(a[-1] is None for a in port[2])  # no-shows sampled
    assert port == run(REF)


def test_vectorized_fast_path_equals_event_path_in_the_port():
    trace = PORT.fleet.synthetic_fleet(6, "mixed", seed=5)
    fast = _run_fleet(PORT, trace, "jit", rng="philox", vectorized=True)
    slow = _run_fleet(PORT, trace, "jit", rng="philox", vectorized=False)
    assert fast[:2] == slow[:2]


def test_philox_streams_match_reference():
    u = np.array([0, 1, 2**64 - 1, 123456789], np.uint64)
    words = [u, u[::-1], u * 3, u + 5, u, u[::-1]]
    for a, b in zip(PORT.streams.philox4x64(*words),
                    REF.streams.philox4x64(*words), strict=True):
        assert np.array_equal(a, b)
    for pattern in ("steady", "diurnal", "straggler", "intermittent",
                    "dropout"):
        jt = {k: P.fleet.synthetic_fleet(1, pattern, seed=4).jobs[0]
              for k, P in (("ref", REF), ("port", PORT))}
        grids = {k: P.streams.PhiloxPartySampler(jt[k], base_seed=9)
                 for k, P in (("ref", REF), ("port", PORT))}
        for field in ("train", "comm", "noshow"):
            assert np.array_equal(getattr(grids["port"], field),
                                  getattr(grids["ref"], field))
        for party, rnd in ((0, 0), (1, 2)):
            assert (PORT.streams.reference_sample(jt["port"], 9, party, rnd)
                    == REF.streams.reference_sample(jt["ref"], 9, party, rnd))


def _both_traces(P):
    trace = P.fleet.synthetic_fleet(6, "mixed", seed=3)
    trace.jobs.append(P.fleet.trace_from_measured(
        P.core.FLJobSpec("real", "x", 1 << 20, parties={
            "p0": P.core.PartySpec("p0", epoch_time_s=5.0)}),
        [{"p0": (5.1, 0.2)}, {"p0": (4.9, 0.2)}], submit_s=10.0))
    return trace


def test_traces_cross_between_packages_byte_for_byte():
    ref, port = _both_traces(REF).dumps(), _both_traces(PORT).dumps()
    assert port == ref
    from_ref = PORT.fleet.WorkloadTrace.loads(ref)
    from_port = REF.fleet.WorkloadTrace.loads(port)
    assert from_ref.dumps() == ref
    assert from_port.dumps() == port
    assert plain(from_ref) == plain(from_port)
    assert from_ref.jobs[-1].measured_rounds[1]["p0"] == (4.9, 0.2)
    # a trace written by the other package runs to the same result
    assert (_run_fleet(PORT, from_ref, "jit")
            == _run_fleet(REF, from_port, "jit"))


@pytest.fixture(scope="module")
def measured_run():
    """The port's own 2-round FedAvg run on the CPU at the small size of
    ``test_torch_job.py`` (3 parties, 2 layers, d_model 64)."""
    configs.load_all()
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    spec = PORT.core.FLJobSpec(
        job_id="it", model_arch=cfg.name, model_bytes=M.n_params(cfg) * 4,
        aggregation_algorithm="fedavg", rounds=2, lr=0.05, batch_size=8,
        parties={f"p{i}": PORT.core.PartySpec(f"p{i}") for i in range(3)})
    res = PORT.api.Platform(t_pair_s=0.01).train(
        cfg, spec, device="cpu", n_sequences=48, eval_sequences=16, seed=0)
    return res.runtime.spec, res.runtime.measured_rounds


@pytest.mark.parametrize("strategy", ["jit", "eager_ao"])
def test_fleet_from_measured_port_run_matches_reference(measured_run,
                                                        strategy):
    spec, measured = measured_run
    assert len(measured) == 2
    jspec = REF.core.FLJobSpec(**{
        **dataclasses.asdict(spec),
        "parties": {pid: REF.core.PartySpec(**dataclasses.asdict(p))
                    for pid, p in spec.parties.items()}})
    port_trace = PORT.fleet.fleet_from_measured(spec, measured, n_jobs=4)
    ref_trace = REF.fleet.fleet_from_measured(jspec, measured, n_jobs=4)
    assert port_trace.dumps() == ref_trace.dumps()
    port = _run_fleet(PORT, port_trace, strategy)
    assert all(m["rounds_done"] == 2 for m in port[0].values())
    assert port == _run_fleet(REF, ref_trace, strategy)


def _cell(report):
    """A CellReport with each run's tracer read out as its billing."""
    return {
        "spec": plain(report.spec),
        "failures": report.failures,
        "excerpts": plain(report.trace_excerpts),
        "summary": report.summary(),
        "runs": {s: {"vehicle": r.vehicle, "arrivals": plain(r.arrivals),
                     "result": plain(r.result),
                     "traced": r.tracer.container_seconds_by_job()}
                 for s, r in report.runs.items()},
    }


_DEFAULT = {s.name: s for s in repro.fleet.conformance.default_matrix()}
_VECTOR = {s.name: s for s in repro.fleet.conformance.vectorized_matrix()}
_PORT_CELLS = {s.name: s for s in
               repro_torch.fleet.conformance.default_matrix()
               + repro_torch.fleet.conformance.vectorized_matrix()}


def test_the_conformance_matrices_match():
    assert ({n: plain(s) for n, s in _PORT_CELLS.items()}
            == {n: plain(s) for n, s in {**_DEFAULT, **_VECTOR}.items()})
    assert (plain(repro_torch.fleet.conformance.long_horizon_matrix())
            == plain(repro.fleet.conformance.long_horizon_matrix()))


@pytest.mark.parametrize("name", sorted(_DEFAULT)[:3] + [
    n for n in sorted(_DEFAULT) if "measured" in n][:1] + sorted(_VECTOR)[:1])
def test_conformance_cell_matches_reference(name):
    port = _cell(PORT.conf.run_cell(_PORT_CELLS[name]))
    assert port["failures"] == []
    assert port == _cell(REF.conf.run_cell({**_DEFAULT, **_VECTOR}[name]))
