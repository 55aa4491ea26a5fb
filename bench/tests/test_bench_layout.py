"""A configuration's leaves: derived from its ``run`` block, or listed in
its file and taken as they stand. Either way they are the program's
``param_specs`` in order, shape, initialiser and std; a listed layout
that is malformed is refused by path; and a configuration that lists its
leaves runs correct through the harness on the CPU."""
import copy
import hashlib
import json
import math
import re
import time
from pathlib import Path

import pytest
import torch

from fedbench import layout, registry, runner
from test_bench_registry import program_config

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SEED = 2**31 + 2828
CONFIGS = [c["name"] for c in registry.benchmark()["configs"]]
#: small configurations that list their leaves (test data, in no cell):
#: a moe block with q/k/v biases and shared experts; ssm, moe and attn
#: blocks over two stages, 72 leaves (two pair_fuse tables a fold)
LISTED = ["tiny-moe", "tiny-hybrid"]
#: sha256 of the derived leaves of the benchmark's two configuration
#: files (json, sorted keys), as the derived route has always given them
DIGESTS = {
    "qwen3-0.6b":
        "bfdbb7e876beccb6cee195046b2ce6fb2c065958b36101997cb9679d66d79eac",
    "mamba2-130m":
        "b8beed2606006ed95d042e7851e816225ff3aee7df40b1d392ad565f76242177",
}


def fixture(name):
    return json.loads((FIXTURES / f"{name}.json").read_text())


def assert_is_the_programs(config):
    """``config``'s resolved leaves against the program's param_specs."""
    from repro_torch import tree_leaves
    from repro_torch.models import model as M

    cfg = program_config(config["run"])
    specs = tree_leaves(M.param_specs(cfg))
    leaves = layout.with_leaves(config)["leaves"]
    assert [tuple(s.shape) for s in specs] == \
        [tuple(leaf["shape"]) for leaf in leaves]
    assert sum(math.prod(leaf["shape"]) for leaf in leaves) == \
        M.n_params(cfg)
    for s, leaf in zip(specs, leaves):
        # the program's zeros dt_bias is drawn as Mamba-2 initialises it
        assert leaf["init"] == s.init or (
            (leaf["init"], s.init) == ("dt_bias", "zeros")
            and leaf["path"][-1] == "dt_bias"), leaf
        if s.init == "normal":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            assert leaf["std"] == s.scale / math.sqrt(max(fan_in, 1))
        else:
            assert "std" not in leaf


@pytest.mark.parametrize("name", CONFIGS)
def test_every_benchmark_configuration_is_the_programs(name):
    assert_is_the_programs(registry.config(name))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_derived_leaves_are_unchanged(name):
    config = registry.config(name)
    assert "leaves" not in config
    leaves = layout.with_leaves(config)["leaves"]
    digest = hashlib.sha256(json.dumps(leaves, sort_keys=True).encode())
    assert digest.hexdigest() == DIGESTS[name]


def test_a_listed_copy_of_the_derived_layout_resolves_to_it():
    config = registry.config("qwen3-0.6b")
    derived = layout.with_leaves(config)["leaves"]
    listed = [{k: leaf[k] for k in ("path", "shape", "init")}
              for leaf in derived]  # every scale there is 1
    out = layout.with_leaves(dict(config, leaves=json.loads(
        json.dumps(listed))))["leaves"]
    assert out == derived


def test_a_listed_layout_is_taken_in_its_own_order_and_scale():
    listed = [
        {"path": ["z"], "shape": [4, 8], "init": "normal", "scale": 0.5},
        {"path": ["a", "b"], "shape": [3], "init": "dt_bias"},
        {"path": ["a", "c"], "shape": [2, 5, 6], "init": "normal"},
    ]
    out = layout.with_leaves({"run": {}, "leaves": listed})["leaves"]
    assert [leaf["path"] for leaf in out] == [["z"], ["a", "b"], ["a", "c"]]
    assert out[0]["std"] == 0.5 / math.sqrt(4)
    assert "std" not in out[1]
    assert out[2]["std"] == 1.0 / math.sqrt(5)


@pytest.mark.parametrize("name", LISTED)
def test_a_listed_fixture_is_the_programs(name):
    config = fixture(name)
    with pytest.raises((KeyError, ValueError)):  # no route from ``run``
        layout.derive(config["run"])
    assert_is_the_programs(config)


@pytest.mark.parametrize("name", LISTED)
def test_a_listed_fixture_runs_correct(name):
    cell = "agg_backlog.qwen3-0.6b"
    traffic = dict(registry.traffic(cell), updates=60, pool=4)
    out = runner.run(cell, SEED, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), config=fixture(name),
                     traffic=traffic)
    limit = min(registry.traffic(w["name"])["limits"]["fold_gap"]
                for w in registry.benchmark()["workloads"])
    assert out["correct"], out["checks"]
    assert out["checks"]["fold_gap"]["value"] < limit


GOOD = [
    {"path": ["embed"], "shape": [8, 4], "init": "normal"},
    {"path": ["stage0", "b0_moe", "attn", "bq"], "shape": [2, 4, 2],
     "init": "zeros"},
    {"path": ["stage0", "b0_moe", "ln1"], "shape": [2, 4], "init": "ones"},
]


def _bad(edit):
    leaves = copy.deepcopy(GOOD)
    edit(leaves)
    return leaves


@pytest.mark.parametrize("leaves, path", [
    (_bad(lambda ls: ls.append(dict(ls[0], init="ones"))), ["embed"]),
    (_bad(lambda ls: ls.append({"path": ["stage0", "b0_moe"],
                                "shape": [2], "init": "ones"})),
     ["stage0", "b0_moe"]),
    (_bad(lambda ls: ls[0].update(shape=[8, 0])), ["embed"]),
    (_bad(lambda ls: ls[0].update(shape=[8, -4])), ["embed"]),
    (_bad(lambda ls: ls[0].update(shape=[8, 4.0])), ["embed"]),
    (_bad(lambda ls: ls[0].update(shape=[True, 4])), ["embed"]),
    (_bad(lambda ls: ls[0].update(shape=[])), ["embed"]),
    (_bad(lambda ls: ls[0].update(shape="8x4")), ["embed"]),
    (_bad(lambda ls: ls[2].update(init="uniform")),
     ["stage0", "b0_moe", "ln1"]),
    (_bad(lambda ls: ls[2].update(init="normal ")),
     ["stage0", "b0_moe", "ln1"]),
    (_bad(lambda ls: ls[0].update(scale=0.0)), ["embed"]),
    (_bad(lambda ls: ls[2].update(scale=0.5)), ["stage0", "b0_moe", "ln1"]),
    (_bad(lambda ls: ls[0].update(std=0.1)), ["embed"]),
], ids=["repeated", "prefix", "zero", "negative", "float", "bool", "empty",
        "not_a_list", "unknown_init", "near_init", "zero_scale",
        "scale_not_normal", "std_given"])
def test_a_malformed_listed_layout_is_refused_by_path(leaves, path):
    with pytest.raises(ValueError, match=re.escape(str(path))):
        layout.with_leaves({"run": {}, "leaves": leaves})


@pytest.mark.parametrize("leaves", [[], None, [["embed"]],
                                    [{"path": "embed", "shape": [1],
                                      "init": "ones"}]])
def test_a_listed_layout_without_paths_is_refused(leaves):
    with pytest.raises(ValueError):
        layout.with_leaves({"run": {}, "leaves": leaves})


@pytest.mark.parametrize("init", layout.INITS)
def test_every_listed_init_is_one_the_weights_draw(init):
    from fedbench import weights

    config = layout.with_leaves({"run": {"dtype": "bfloat16"}, "leaves": [
        {"path": ["w"], "shape": [3, 5], "init": init}]})
    gen = torch.Generator().manual_seed(SEED)
    w = weights.make_model(config, gen, torch.device("cpu"))["w"]
    assert w.shape == (3, 5) and w.dtype == torch.bfloat16


def test_the_good_layout_is_taken():
    assert [leaf["path"] for leaf in layout.with_leaves(
        {"run": {}, "leaves": GOOD})["leaves"]] == [g["path"] for g in GOOD]
