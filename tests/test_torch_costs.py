"""The port's kernel cost table (``repro_torch.kernels.autotune``): the byte
model of the CUDA kernels, a table that crosses between the two packages in
both directions with equal ``t_pair``, the simulation vehicles priced by one
table in both packages (equal with ``==``), and the measured basis, which
needs the card."""
import json

import pytest
import torch

import repro.api
import repro.core
import repro.fleet
import repro.kernels.autotune as jtune
import repro_torch.api
import repro_torch.core
import repro_torch.fleet
import repro_torch.kernels.autotune as tune
from _torch_parity import plain

# the JOB_MIX sizes of the synthetic fleets and qwen3-0.6b's bf16 model
SIZES = (52_428_800, 209_715_200, 524_288_000, 1_503_264_768)


@pytest.mark.parametrize("kernel,k,n,want", [
    ("pair_fuse", 2, 1000, 12_000),  # two fp32 reads, one fp32 write
    ("pair_fuse", 8, 7, 84),  # k does not enter
    ("fused_agg", 8, 1000, 36_032),  # (4K + 4) n + 4K
    ("fused_agg", 3, 5, 92),
    ("quant_agg", 8, 1000, 12_032),  # (K + 4) n + 4K
    ("quant_agg", 1, 1, 9),
])
def test_kernel_bytes_moved_by_hand(kernel, k, n, want):
    assert tune.kernel_bytes_moved(kernel, k, n) == want
    assert tune.roofline_s(kernel, k, n) == want / 3.35e12


def test_roofline_table_rows():
    table = tune.build_cost_table(SIZES, basis="roofline")
    assert table.hw == "h100" and len(table.entries) == 12
    for e in table.entries:
        spec = tune.KERNELS[e.kernel]
        n = e.model_bytes // spec.in_itemsize
        pairs = 1 if e.kernel == "pair_fuse" else 7
        # the launch shape is the closed-form search's choice
        choice = tune.autotune(e.kernel, spec.k, n)
        assert (e.bn, e.kb, e.basis) == (choice.bn, choice.kb, "roofline")
        assert e.t_pair_s == tune.kernel_bytes_moved(
            e.kernel, spec.k, n) / 3.35e12 / pairs
    # the full bf16 model of qwen3-0.6b as two fp32 vectors: 1.346 ms
    full = table.t_pair(SIZES[-1])
    assert full == 12 * (SIZES[-1] // 4) / 3.35e12
    assert round(full * 1e3, 3) == 1.346


# sizes inside, between, at and outside the table's rows
PROBES = (1, 10_000_000, 52_428_800, 100_000_000, 700_000_000, 4_000_000_000)


def test_table_crosses_between_packages_both_ways(tmp_path):
    table = tune.build_cost_table(SIZES, basis="roofline")
    table.dump(tmp_path / "port.json")
    ref = jtune.KernelCostTable.load(str(tmp_path / "port.json"))
    assert ref.hw == "h100"
    for kernel in tune.KERNELS:
        for mb in PROBES:
            assert ref.t_pair(mb, kernel) == table.t_pair(mb, kernel)
            assert ref.tile(mb, kernel) == table.tile(mb, kernel)
    # and back: the reference's own table loads in the port
    jtable = jtune.build_cost_table(SIZES[:3], basis="roofline")
    jtable.dump(str(tmp_path / "ref.json"))
    back = tune.KernelCostTable.load(tmp_path / "ref.json")
    assert back.hw == "tpu_v5e"
    assert back.to_json() == jtable.to_json()
    for kernel in jtable.kernels():
        for mb in PROBES:
            assert back.t_pair(mb, kernel) == jtable.t_pair(mb, kernel)
    # one JSON layout: the same keys in both
    with open(tmp_path / "port.json") as f, open(tmp_path / "ref.json") as g:
        a, b = json.load(f), json.load(g)
    assert set(a) == set(b) and set(a["entries"][0]) == set(b["entries"][0])


def _tables():
    port = tune.build_cost_table(SIZES, basis="roofline")
    return port, jtune.KernelCostTable.from_json(port.to_json())


@pytest.mark.parametrize("strategy", ["jit", "eager_ao"])
def test_fleet_priced_by_one_table_matches_reference(strategy):
    port_t, ref_t = _tables()

    def run(api, core, fleet, table):
        platform = api.Platform(core.ClusterConfig(capacity=8),
                                cost_table=table)
        runner = platform.submit_fleet(fleet.synthetic_fleet(16), strategy)
        platform.run()
        return plain(runner.result()), platform.estimator.calib_scale
    port = run(repro_torch.api, repro_torch.core, repro_torch.fleet, port_t)
    assert port == run(repro.api, repro.core, repro.fleet, ref_t)
    # the table prices the fleet: its bill differs from the constant's
    const = repro_torch.api.Platform(repro_torch.core.ClusterConfig(
        capacity=8))
    runner = const.submit_fleet(repro_torch.fleet.synthetic_fleet(16),
                                strategy)
    const.run()
    assert (runner.result().fleet.container_seconds
            != port[0]["fleet"]["container_seconds"])


def test_run_job_and_estimator_priced_by_one_table_match_reference():
    port_t, ref_t = _tables()

    def run(api, core, table):
        job = core.FLJobSpec("j", "x", 300_000_000, rounds=2, parties={
            f"p{i}": core.PartySpec(f"p{i}", epoch_time_s=40.0 + i)
            for i in range(5)})
        est = core.AggregationEstimator(0.05, cost_table=table)
        return (plain(api.run_job(job, "jit", cost_table=table)),
                est.t_agg(job), est.t_pair_for(job.model_bytes))
    port = run(repro_torch.api, repro_torch.core, port_t)
    assert port[2] == port_t.t_pair(300_000_000)
    assert port == run(repro.api, repro.core, ref_t)


def test_measured_basis_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.build_cost_table(SIZES[:1], basis="measured")
    with pytest.raises(ValueError, match="CUDA device"):
        tune.build_cost_table(SIZES[:1], basis="measured", device="cpu")
    with pytest.raises(ValueError, match="basis"):
        tune.build_cost_table(SIZES[:1], basis="guessed")


def test_cli_writes_a_roofline_table(tmp_path, capsys):
    out = tmp_path / "table.json"
    tune.main(["--sizes-mb", "50,200", "--out", str(out)])
    table = jtune.KernelCostTable.load(str(out))
    assert len(table.entries) == 6 and table.hw == "h100"
    assert f"[wrote {out}: 6 entries]" in capsys.readouterr().out
