"""The port's benchmarks (``repro_torch.benchmarks``) against the JAX
package's ``benchmarks/`` on the CPU.

The simulation twins run on a virtual clock: each one's rows and printed
CSV are ``==`` the reference's, leaving out only the columns the
reference's own tests treat as wall clock (simcore's timings). Of the
benchmarks that train or time kernels, what does not depend on the
framework is held ``==``: real_ablation's pricing of one set of measured
rounds under every strategy, periodicity's R^2. Their measurements run
here with ``device="cpu"`` at tiny sizes; the kernels' measured rows need
the card, and every card entry point raises without one."""
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import periodicity as jperiodicity
from benchmarks import real_ablation as jreal_ablation
from repro import configs as jconfigs
from repro.api import replay_measured as jreplay_measured
from repro.core import AggregationEstimator as JAggregationEstimator
from repro.core import PolicyConfig as JPolicyConfig
from repro.core import STRATEGIES as JSTRATEGIES
from repro.core.cluster import ClusterConfig as JClusterConfig
from repro.core.jobspec import PartySpec as JPartySpec
from repro_torch import configs
from repro_torch.benchmarks import (kernel_bench, periodicity, real_ablation,
                                    run as bench_run, simcore)
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.jobspec import PartySpec
from repro_torch.kernels import autotune
from repro_torch.kernels.build import default_tile

from _torch_parity import plain

ROOT = Path(__file__).resolve().parents[1]

#: (module, run's keyword arguments): the reference's own small arguments
SIMULATIONS = [
    ("latency", dict(rounds=3)),
    ("latency", dict(rounds=3, counts=[10])),
    ("resources", dict(rounds=3)),
    ("resources", dict(rounds=3, counts=[10])),
    ("jit_ablation", dict(rounds=3)),
    ("prediction_accuracy", {}),
    ("drift", {}),
    ("multijob", {}),
    ("hierarchical", {}),
    ("fleet", dict(smoke=True)),
    ("online", dict(smoke=True)),
]
#: simcore's wall-clock columns (``tests/test_simcore_bench.py`` locks only
#: the rest)
SIMCORE_WALL = ("wall_s", "arrivals_per_sec", "events_per_sec",
                "wall_s_per_sim_hour", "peak_rss_kb")


def _both(name, kw, capsys):
    """(reference rows, its printed text, port rows, its printed text)."""
    import importlib

    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    want = ref.run(**kw)
    want_out = capsys.readouterr().out
    got = port.run(**kw)
    got_out = capsys.readouterr().out
    return want, want_out, got, got_out


@pytest.mark.parametrize("name,kw", SIMULATIONS,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in SIMULATIONS])
def test_simulation_twin_rows_and_csv_equal_the_reference(name, kw, capsys):
    want, want_out, got, got_out = _both(name, kw, capsys)
    assert plain(got) == plain(want)
    assert got_out == want_out
    assert got_out.strip()


def _masked(rows):
    return [{k: v for k, v in r.items() if k not in SIMCORE_WALL}
            for r in rows]


def _masked_csv(text):
    cols = simcore.HEADER.split(",")
    keep = [i for i, c in enumerate(cols) if c not in SIMCORE_WALL]
    out = []
    for line in text.splitlines():
        parts = line.split(",")
        if len(parts) == len(cols):
            out.append([parts[i] for i in keep])
        elif not line.startswith("[speedup"):
            out.append(line)
    return out


def test_simcore_twin_deterministic_columns(capsys):
    """simcore's smoke cell: every column but the wall clock ``==`` the
    reference's (rows and printed CSV), and the simulated work equal to the
    committed ``benchmarks/simcore_baseline.json``."""
    (want, _), want_out, (got, sp), got_out = _both(
        "simcore", dict(smoke=True), capsys)
    assert _masked(got) == _masked(want)
    assert _masked_csv(got_out) == _masked_csv(want_out)
    assert set(sp) == {"small"} and sp["small"] > 0
    base = json.loads((ROOT / "benchmarks" / "simcore_baseline.json"
                       ).read_text())
    base_by = {(r["cell"], r["mode"]): r for r in base["rows"]}
    for r in got:
        b = base_by[(r["cell"], r["mode"])]
        for col in ("n_jobs", "parties_per_job", "rounds_per_job",
                    "arrivals", "events"):
            assert r[col] == b[col], (r["mode"], col)


# --------------------------------------------------------------------------
# real_ablation
# --------------------------------------------------------------------------
def _measured_rounds(parties=4, rounds=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{f"p{i}": (float(rng.uniform(20.0, 90.0)),
                       float(rng.uniform(1.0, 30.0)))
             for i in range(parties)} for _ in range(rounds)]


def test_real_ablation_replay_equals_the_reference(capsys):
    """One set of measured rounds priced under every strategy: the twin's
    ``replay_strategies`` against the reference's loop in ``run`` (the
    training itself differs by framework and is not compared)."""
    jconfigs.load_all()
    name, parties, rounds = "example-100m", 4, 3
    cfg = configs.get_config(name).reduced(num_layers=2, d_model=64,
                                           vocab_size=128)
    jcfg = jconfigs.get_config(name).reduced(num_layers=2, d_model=64,
                                             vocab_size=128)
    measured = _measured_rounds(parties, rounds)
    timed = {f"p{i}": 60.0 for i in range(parties)}

    spec = real_ablation.build_spec(cfg, parties, rounds, 8)
    spec = dataclasses.replace(spec, parties={
        p: PartySpec(p, epoch_time_s=t) for p, t in timed.items()})
    jspec = jreal_ablation.build_spec(jcfg, parties, rounds, 8)
    jspec = dataclasses.replace(jspec, parties={
        p: JPartySpec(p, epoch_time_s=t) for p, t in timed.items()})
    assert plain(spec) == plain(jspec)
    t_pair0 = 3.0 * spec.model_bytes / 10e9

    got = real_ablation.replay_strategies(spec, measured, ClusterConfig(),
                                          t_pair0, parties)
    capsys.readouterr()
    bt = max(2, parties // 5)
    want = [jreplay_measured(
        jspec, measured,
        "jit" if s == "jit" else JPolicyConfig(strategy=s, batch_trigger=bt),
        cluster_config=JClusterConfig(),
        estimator=JAggregationEstimator(t_pair0)) for s in JSTRATEGIES]
    assert [m.strategy for m in got] == list(JSTRATEGIES)
    assert plain(got) == plain(want)
    assert real_ablation.jit_within_always_on(got)


def test_real_ablation_runs_on_the_cpu_when_told(capsys):
    cfg = configs.get_config("example-100m").reduced(
        num_layers=2, d_model=64, vocab_size=128)
    result, rows = real_ablation.run(cfg, rounds=1, sequences=16, parties=2,
                                     device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [m.strategy for m in rows] == list(JSTRATEGIES)
    assert [line.split(",")[0] for line in out] == list(JSTRATEGIES)
    assert all(m.rounds_done == 1 for m in rows)
    assert len(result.runtime.measured_rounds) == 1
    assert str(result.runtime.device) == "cpu"


# --------------------------------------------------------------------------
# periodicity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_periodicity_r2_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(1, 100, 6)
    ys = 0.3 * xs + rng.normal(0, 2.0, 6)
    assert periodicity.r2(xs, ys) == jperiodicity.r2(xs, ys)
    assert periodicity.r2([1, 2, 3], [2, 4, 6]) == jperiodicity.r2(
        [1, 2, 3], [2, 4, 6])


def test_periodicity_measures_on_the_cpu_at_tiny_sizes():
    mb, ep = periodicity.measure_epochs(n_epochs=2, batch_size=4,
                                        n_sequences=8, device="cpu")
    assert mb.shape == (4,) and ep.shape == (2,)
    assert (mb > 0).all() and (ep >= mb.reshape(2, 2).sum(1)).all()
    lin = periodicity.measure_linearity_batch((2, 4), device="cpu")
    assert [b for b, _ in lin] == [2, 4] and all(t > 0 for _, t in lin)
    lin = periodicity.measure_linearity_dataset((8, 16), batch_size=4,
                                                device="cpu")
    assert [n for n, _ in lin] == [8, 16] and all(t > 0 for _, t in lin)


# --------------------------------------------------------------------------
# kernel_bench
# --------------------------------------------------------------------------
def test_kernel_bench_model_rows_deterministic():
    rows = kernel_bench.model_rows()
    assert rows == kernel_bench.model_rows()
    assert [(r["kernel"], r["k"], r["n"]) for r in rows] == list(
        kernel_bench.MODEL_CASES)
    for r in rows:
        # the closed form keeps the default shape: each moves the same bytes
        assert (r["tuned_bn"], r["tuned_kb"]) == default_tile(r["kernel"])
        assert r["bytes_default"] == r["bytes_tuned"] == \
            autotune.kernel_bytes_moved(r["kernel"], r["k"], r["n"])
        assert r["steps_default"] == -(-r["n"] // r["default_bn"])
        assert r["modeled_speedup"] == 1.0
    assert list(rows[0]) == kernel_bench.MODEL_HEADER.split(",")


def _measured_row(kernel="fused_agg", k=8, n=1 << 25, us=400.0):
    bn, kb = default_tile(kernel)
    bound = autotune.roofline_s(kernel, k, n) * 1e6
    return {"kernel": kernel, "k": k, "n": n, "default_bn": bn,
            "default_kb": kb, "tuned_bn": bn, "tuned_kb": kb,
            "best_bn": bn, "best_kb": kb, "us_default": us, "us_tuned": us,
            "us_best": us, "us_bound": bound, "worst_over_bound": us / bound,
            "measured_speedup": 1.0, "best_speedup": 1.0}


def test_kernel_bench_check_passes_on_self_and_fails_on_drift(tmp_path,
                                                              capsys):
    model = kernel_bench.model_rows()
    measured = [_measured_row()]
    sp = kernel_bench.speedups(measured)
    path = tmp_path / "base.json"
    path.write_text(json.dumps({"model_rows": model,
                                "measured_rows": measured, "speedups": sp}))
    kernel_bench.check_against(str(path), model, measured, sp)
    assert "check OK" in capsys.readouterr().out

    drift = [dict(r) for r in model]
    drift[0]["tuned_bn"] = 512
    path.write_text(json.dumps({"model_rows": drift,
                                "measured_rows": measured, "speedups": sp}))
    with pytest.raises(SystemExit):
        kernel_bench.check_against(str(path), model, measured, sp)

    moved = [dict(measured[0], tuned_kb=4)]
    path.write_text(json.dumps({"model_rows": model, "measured_rows": moved,
                                "speedups": sp}))
    with pytest.raises(SystemExit):
        kernel_bench.check_against(str(path), model, measured, sp)

    inflated = {k: v / kernel_bench.CHECK_SPEEDUP_FRACTION * 1.01
                for k, v in sp.items()}
    path.write_text(json.dumps({"model_rows": model,
                                "measured_rows": measured,
                                "speedups": inflated}))
    with pytest.raises(SystemExit):
        kernel_bench.check_against(str(path), model, measured, sp)

    slow = [_measured_row(us=1.26 * _measured_row()["us_bound"])]
    path.write_text(json.dumps({"model_rows": model, "measured_rows": slow,
                                "speedups": sp}))
    with pytest.raises(SystemExit):
        kernel_bench.check_against(str(path), model, slow, sp)


def test_kernel_bench_on_the_cpu_writes_model_rows_and_a_roofline_table(
        tmp_path, capsys):
    out, table = tmp_path / "k.json", tmp_path / "t.json"
    model, measured, sp = kernel_bench.main(
        ["--device", "cpu", "--out", str(out), "--emit-cost-table",
         str(table)])
    assert measured == [] and sp == {}
    assert json.loads(out.read_text())["model_rows"] == model
    t = autotune.KernelCostTable.load(str(table))
    assert {e.basis for e in t.entries} == {"roofline"}
    assert len(t.entries) == 15
    kernel_bench.main(["--device", "cpu", "--out", "", "--check", str(out)])
    assert "check OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="CUDA device"):
        kernel_bench.measured_rows("cpu")


def test_card_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("example-100m").reduced(
        num_layers=1, d_model=32, vocab_size=64)
    for call in (lambda: kernel_bench.run(),
                 lambda: kernel_bench.measured_rows(),
                 lambda: kernel_bench.main(["--out", ""]),
                 lambda: real_ablation.run(cfg, rounds=1, sequences=8,
                                           parties=2),
                 lambda: real_ablation.main(["--reduced"]),
                 lambda: periodicity.measure_epochs(),
                 lambda: periodicity.measure_linearity_batch(),
                 lambda: periodicity.main([]),
                 lambda: bench_run.main(["--only", "kernels"]),
                 lambda: bench_run.main(["--only", "periodicity"]),
                 lambda: bench_run.main(["--only", "dist_agg"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------
# run.py
# --------------------------------------------------------------------------
def test_run_only_drift_prints_its_section(capsys):
    from benchmarks import drift as jdrift

    jdrift.main()
    want = capsys.readouterr().out
    bench_run.main(["--only", "drift"])
    got = capsys.readouterr().out.splitlines()
    assert got[1] == "===== §4.2 drift: epoch-time prediction under " \
                     "dataset growth ====="
    assert "\n".join(got[2:2 + len(want.splitlines())]) + "\n" == want
    assert got[-1].startswith("[benchmarks done in ")
    assert not any("=====" in line for line in got[2:])


def test_every_reference_section_but_dist_agg_has_a_twin():
    """Every section, dist_agg too since it has a twin, in the
    reference's order (the name is older than dist_agg's twin)."""
    src = (ROOT / "src" / "repro_torch" / "benchmarks" / "run.py").read_text()
    ref = (ROOT / "benchmarks" / "run.py").read_text()

    sections = re.findall(r'only in \(None, "(\w+)"\)', ref)
    assert re.findall(r'only in \(None, "(\w+)"\)', src) == sections
    assert "dist_agg" in sections
