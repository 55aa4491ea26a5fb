"""The harness finds its parts by name and refuses unknown ones; the
configuration files lay out the program's parameters."""
import dataclasses
import math

import pytest

from fedbench import layout, registry, runner


def test_every_part_of_every_cell_is_found():
    b = registry.benchmark()
    for cell in b["workloads"]:
        traffic = registry.traffic(cell["name"])
        assert registry.config(cell["config"])["name"] == cell["config"]
        assert hasattr(registry.kind(traffic["kind"]), "Traffic")
        for trace in (False, True):
            for m in registry.metrics_of(cell["name"], trace):
                assert callable(registry.reader(m["name"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(registry.reader(m["name"]))


@pytest.mark.parametrize("find, name", [
    (registry.cell, "no_such.cell"), (registry.config, "no-such-model"),
    (registry.traffic, "no_such.cell"), (registry.kind, "no_such_kind"),
    (registry.reader, "no_such_metric")])
def test_unknown_names_are_refused(find, name):
    with pytest.raises(KeyError):
        find(name)


@pytest.mark.parametrize("name", ["../BENCHMARK", "a b", "", "x/y"])
def test_malformed_names_are_refused(name):
    with pytest.raises(ValueError):
        registry.reader(name)


def test_each_cell_reports_setup_and_another_end_to_end_and_a_layer():
    for cell in registry.benchmark()["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(cell["name"], True)


def program_config(run):
    """The program's registered configuration with the file's sizes."""
    from repro_torch.configs import get_config

    base = get_config(run["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in run.items() if k in fields})


@pytest.mark.parametrize("name, n_params, n_leaves", [
    ("qwen3-0.6b", 751_632_384, 14), ("mamba2-130m", 167_567_808, 17)])
def test_layout_is_the_programs(name, n_params, n_leaves):
    from repro_torch.models import model as M
    from repro_torch import tree_leaves

    config = layout.with_leaves(registry.config(name))
    cfg = program_config(config["run"])
    specs = M.param_specs(cfg)
    assert [tuple(s.shape) for s in tree_leaves(specs)] == \
        [tuple(leaf["shape"]) for leaf in config["leaves"]]
    assert sum(math.prod(leaf["shape"]) for leaf in config["leaves"]) == \
        M.n_params(cfg) == n_params
    assert len(config["leaves"]) == n_leaves
    for key, value in config["run"].items():
        if key != "arch":
            got = getattr(cfg, key)
            assert (list(got) if isinstance(got, tuple) else got) == value


def test_forbidden_modules_compare_whole_top_level_names():
    import sys
    import types

    sys.modules["repro_torch_like"] = types.ModuleType("repro_torch_like")
    try:
        assert runner.forbidden_modules() == []
        sys.modules["repro.fake"] = types.ModuleType("repro.fake")
        assert runner.forbidden_modules() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_like", None)
        sys.modules.pop("repro.fake", None)
