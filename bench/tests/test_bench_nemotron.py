"""Nemotron-3-Nano's configuration: one card's share of stage 0 (13 of 52
layers, 16 of 128 experts, 16,384 of 131,072 vocabulary rows), its leaves
listed. They are the program's ``param_specs`` of the cut in order,
shape, initialiser and std; a fold of them takes three ``pair_fuse``
tables; and its cell runs correct through the harness on the CPU at a
small size (``fixtures/tiny-nemotron.json``, the cut's 13 layers at small
widths). The tiny copy is also the cell's small configuration in the
suite's other per-cell tests (``conftest.TINY``)."""
import math
import time

import pytest
import torch

import conftest
from fedbench import layout, registry, runner
from test_bench_layout import assert_is_the_programs, fixture

NAME = "nemotron-3-nano-30b-a3b"
CELL = f"agg_backlog.{NAME}"
SEED = 2**31 + 2929
conftest.TINY.setdefault(NAME, fixture("tiny-nemotron"))


def test_every_cell_has_a_small_configuration():
    assert {w["config"] for w in registry.benchmark()["workloads"]} <= \
        set(conftest.TINY)


def test_the_configuration_is_the_programs_cut():
    from repro_torch.models import model as M

    from test_bench_registry import program_config

    config = registry.config(NAME)
    assert_is_the_programs(config)
    cfg = program_config(config["run"])
    assert M.n_params(cfg) == 1_267_091_968
    assert (cfg.num_layers, cfg.experts_held, cfg.vocab_size) == \
        (config["num_hidden_layers"], config["n_routed_experts"],
         config["vocab_size"]) == (13, 16, 16_384)
    assert cfg.num_experts == config["published"]["n_routed_experts"] == 128
    leaves = layout.with_leaves(config)["leaves"]
    assert len(leaves) == 150
    experts = sum(math.prod(leaf["shape"]) for leaf in leaves
                  if leaf["path"][-1] in ("w_up", "w_down")
                  and "shared" not in leaf["path"])
    assert experts == 798_228_480


def test_a_fold_takes_three_tables():
    from repro_torch.kernels.pair_fuse import TABLE_MAX, Operands, plan

    leaves = layout.with_leaves(registry.config(NAME))["leaves"]
    pairs, at = [], 1 << 20
    for leaf in leaves:  # an fp32 accumulator and a bf16 update a leaf
        n = math.prod(leaf["shape"])
        pairs.append(Operands(torch.float32, torch.bfloat16, n, at,
                              at + (1 << 40), at + (2 << 40)))
        at += 256 * (-(-n * 4 // 256) + 1)
    launches = plan(pairs, 4, 256)
    assert [len(x.entries) for x in launches] == [TABLE_MAX, TABLE_MAX, 22]


def test_the_fixture_is_the_programs():
    with pytest.raises((KeyError, ValueError)):  # no route from ``run``
        layout.derive(fixture("tiny-nemotron")["run"])
    assert_is_the_programs(fixture("tiny-nemotron"))


def test_the_cell_runs_correct_on_the_cpu(tiny):
    config, traffic = tiny(CELL)
    out = runner.run(CELL, SEED, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), config=config, traffic=traffic)
    assert out["correct"], out["checks"]
    assert out["checks"]["fold_gap"]["value"] < \
        registry.traffic(CELL)["limits"]["fold_gap"]
