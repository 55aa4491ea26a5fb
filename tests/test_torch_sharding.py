"""The port's sharding rules and context (``repro_torch/launch/sharding.py``,
``repro_torch/models/sharding_ctx.py``, ``steps.shardings``,
``spec.axes_tree``) against the JAX package's, with no ranks.

``resolve_spec`` is a function of axis sizes alone, so it is held on the
reference's production layouts (16 x 16 and 2 x 16 x 16) and on 2 x 2
against ``jax.sharding.AbstractMesh``; the port takes a mapping of axis
sizes for the same layout. A port spec is a plain tuple in
``PartitionSpec``'s normal form, so ``tuple(ref_spec) == port_spec`` is the
comparison, exact. ``local_shard`` is held against ``addressable_shards``
on a concrete 2 x 2 mesh of the 8 virtual host devices ``conftest.py``
forces, and the analytic ``dist_agg`` rows against the reference's
``run_one``, which needs 256 devices and so runs in a subprocess with 512
forced host devices (as its own ``main`` does).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import ARCH_IDS
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models import sharding_ctx as jctx
from repro.models.spec import TensorSpec as JTensorSpec
from repro.models.spec import axes_tree as jaxes_tree
from repro_torch import configs, tree_leaves
from repro_torch.benchmarks import dist_agg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models import sharding_ctx as ctx
from repro_torch.models.spec import axes_tree

jconfigs.load_all()
configs.load_all()
ROOT = Path(__file__).resolve().parents[1]

LAYOUTS = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
}
RULES = {"param": (jshd.PARAM_RULES, shd.PARAM_RULES),
         "decode": (jshd.DECODE_PARAM_RULES, shd.DECODE_PARAM_RULES)}


def _amesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JTensorSpec))


def test_rule_tables_are_the_reference_s():
    assert shd.PARAM_RULES == jshd.PARAM_RULES
    assert shd.DECODE_PARAM_RULES == jshd.DECODE_PARAM_RULES
    assert shd.ACT_RULES == jshd.ACT_RULES
    assert shd.PRIORITY == jshd.PRIORITY
    assert steps.CACHE_RULES == jsteps.CACHE_RULES
    assert ctx.DEFAULT_OFF == jctx.DEFAULT_OFF


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_equals_reference(arch, rules, layout):
    jrules, prules = RULES[rules]
    sizes = LAYOUTS[layout]
    jspecs = _jleaves(JM.param_specs(jconfigs.get_config(arch)))
    pspecs = tree_leaves(M.param_specs(configs.get_config(arch)))
    assert len(jspecs) == len(pspecs)
    sharded = 0
    for js, ps in zip(jspecs, pspecs):
        assert (js.shape, js.axes) == (ps.shape, ps.axes)
        want = tuple(jshd.resolve_spec(js.shape, js.axes, _amesh(sizes),
                                       jrules))
        got = shd.resolve_spec(ps.shape, ps.axes, sizes, prules)
        assert got == want, (arch, js.shape, js.axes)
        sharded += any(e is not None for e in got)
    assert sharded  # the layout shards something of every model


@pytest.mark.parametrize("profile", ["baseline", "optimized"])
@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_shardings_equal_reference_build(arch, shape, profile):
    """``steps.shardings`` against the third item of the reference's
    ``build`` on the 16 x 16 layout, spec for spec (``build`` allocates
    nothing: its arguments are ShapeDtypeStructs)."""
    sizes = LAYOUTS["16x16"]
    _, _, want, _ = jsteps.build(jconfigs.get_config(arch), JSHAPES[shape],
                                 _amesh(sizes), profile=profile)
    got = steps.shardings(configs.get_config(arch), INPUT_SHAPES[shape],
                          sizes, profile=profile)
    want = jax.tree.leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, shd.NamedSharding) and g.mesh is sizes
        assert g.spec == tuple(w.spec)
    # build's arguments line up with the shardings, leaf for leaf
    _, args, _ = steps.build(configs.get_config(arch), INPUT_SHAPES[shape])
    assert [len(a.shape) for a in tree_leaves(args)] == [len(g.spec)
                                                       for g in got]


def test_unknown_profile_raises():
    with pytest.raises(ValueError, match="profile"):
        steps.shardings(configs.get_config("qwen3-0.6b"),
                        INPUT_SHAPES["train_4k"], LAYOUTS["2x2"], "fast")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_batch_sharding_and_activation_rules_equal_reference(layout):
    sizes = LAYOUTS[layout]
    for shape in [(256, 4096), (32, 128, 1024), (8, 1), (3, 7), (512,)]:
        for dim in range(len(shape)):
            want = jshd.batch_sharding(_amesh(sizes), shape, batch_dim=dim)
            got = shd.batch_sharding(sizes, shape, batch_dim=dim)
            assert got.spec == tuple(want.spec), (shape, dim)
    for sp in (False, True):
        assert (shd.activation_rules(sizes, sp)
                == jshd.activation_rules(_amesh(sizes), sp))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_equals_reference(arch):
    want = jaxes_tree(JM.param_specs(jconfigs.get_config(arch)))
    got = axes_tree(M.param_specs(configs.get_config(arch)))
    assert got == want  # nested dicts of axis tuples, leaf for leaf


FEATURES = ["moe_shard_map", "kv_anchor", "vocab_parallel",
            "decode_tp_params"]
ENV = ["", "kv_anchor", "moe_shard_map, vocab_parallel", "kv_anchor,bogus"]


@pytest.mark.parametrize("enable", ENV)
@pytest.mark.parametrize("disable", ENV)
@pytest.mark.parametrize("profile", ["baseline", "optimized"])
def test_opt_feature_equals_reference(profile, disable, enable, monkeypatch):
    monkeypatch.setenv("REPRO_DISABLE_OPT", disable)
    monkeypatch.setenv("REPRO_ENABLE_OPT", enable)
    sizes = LAYOUTS["2x2"]
    rules = shd.activation_rules(sizes, False)
    for name in FEATURES:  # no context installed: every feature is off
        assert ctx.opt_feature(name) is jctx.opt_feature(name) is False
    with jctx.activation_sharding(_amesh(sizes), rules, profile=profile), \
            ctx.activation_sharding(sizes, rules, profile=profile):
        assert ctx.is_optimized() == jctx.is_optimized()
        for name in FEATURES:
            assert ctx.opt_feature(name) == jctx.opt_feature(name), name
        want, got = jctx.moe_shard_map_ctx(), ctx.moe_shard_map_ctx()
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] is sizes and got[1:] == want[1:]
    assert ctx.is_optimized() is False


def test_moe_shard_map_ctx_on_each_layout():
    for sizes in LAYOUTS.values():
        rules = shd.activation_rules(sizes, True)
        with jctx.activation_sharding(_amesh(sizes), rules, "optimized"), \
                ctx.activation_sharding(sizes, rules, "optimized"):
            assert ctx.moe_shard_map_ctx()[1:] == jctx.moe_shard_map_ctx()[1:]
    with ctx.activation_sharding({"data": 4}, {}, "optimized"):
        assert ctx.moe_shard_map_ctx() is None  # no model axis


def test_constrain_leaves_a_plain_tensor_as_it_is():
    x = torch.randn(4, 8, 16)
    sizes = LAYOUTS["2x2"]
    assert ctx.constrain(x, ("batch", "seq", "d_model")) is x
    with ctx.activation_sharding(sizes, shd.activation_rules(sizes, True),
                                 "optimized"):
        assert ctx.constrain(x, ("batch", "seq", "d_model")) is x


SPECS = [(None, None), ("data", None), (None, "model"), ("data", "model"),
         ("model", "data"), (("data", "model"), None),
         (None, ("model", "data")), ("model", None)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_local_shard_equals_reference_addressable_shards(spec):
    """Every device's shard on a concrete 2 x 2 mesh (two axes on one dim
    included: the major axis splits first)."""
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    jmesh = Mesh(devs, ("data", "model"))
    arr = np.random.default_rng(7).standard_normal((8, 12)).astype(np.float32)
    placed = jax.device_put(arr, JNamedSharding(jmesh, P(*spec)))
    sharding = shd.NamedSharding(LAYOUTS["2x2"], spec)
    where = {d: c for c, d in np.ndenumerate(devs)}
    assert len(placed.addressable_shards) == 4
    for s in placed.addressable_shards:
        got = shd.local_shard(torch.from_numpy(arr), sharding,
                              where[s.device])
        np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
        np.testing.assert_array_equal(got.numpy(), arr[s.index])


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    two = shd.NamedSharding(LAYOUTS["2x2"], (("data", "model"), None))
    assert two.placements() == (Shard(0), Shard(0))
    assert shd.NamedSharding(LAYOUTS["2x2"], (None, "data")).placements() \
        == (Shard(1), Replicate())
    three = shd.NamedSharding(LAYOUTS["2x16x16"], (("pod", "data"), "model"))
    assert three.placements() == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="divide"):
        shd.local_shard(torch.zeros(3, 4), two, (0, 1))
    with pytest.raises(ValueError, match="mesh order"):
        shd.NamedSharding(LAYOUTS["2x2"], (("model", "data"),)).placements()


def test_mesh_builders_raise_without_the_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    for build, ranks in [(lambda: mesh_mod.make_host_mesh(2, 2, "cpu"), 4),
                         (lambda: mesh_mod.make_production_mesh(
                             device="cpu"), 256),
                         (lambda: mesh_mod.make_production_mesh(
                             multi_pod=True, device="cpu"), 512)]:
        with pytest.raises(RuntimeError, match=f"{ranks} ranks"):
            build()


def test_dist_agg_rows_equal_reference():
    """The analytic rows of the four architectures: params, K, bytes a rank
    and the CPU column ``==`` the reference's; the GPU columns are the same
    bytes over the H100's 3.35 TB/s; no collective in the fusion."""
    code = ("import json\n"
            "from benchmarks import dist_agg\n"
            "print(json.dumps([dist_agg.run_one(a) for a in "
            "dist_agg.ARCHS]))\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert [w["arch"] for w in want] == dist_agg.ARCHS
    for w in want:
        got = dist_agg.run_one(w["arch"], device="cpu")
        for key in ("params", "k", "bytes_per_chip", "t_agg_cpu_1000p_s"):
            assert got[key] == w[key], (w["arch"], key)
        assert got["collectives"] == w["collectives_in_hlo"] == 0
        assert got["t_agg_gpu_ms"] == round(
            w["bytes_per_chip"] / 3.35e12 * 1e3, 3)
    qwen3 = dist_agg.run_one("qwen3-0.6b", device="cpu")
    assert qwen3["params"] == 751_632_384
    assert qwen3["bytes_per_chip"] == 105_698_304  # 2,936,064 a rank x 9 x 4


def test_dist_agg_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_agg.run_one("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_agg.measure("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_host_mesh(1, 1)


def test_dist_agg_cli_and_its_benchmark_section_print_the_rows(capsys):
    from repro_torch.benchmarks import run as bench_run

    dist_agg.main(["--device", "cpu"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == dist_agg.HEADER and len(rows) == 1 + len(dist_agg.ARCHS)
    assert rows[1].startswith("qwen3-0.6b,751632384,8,105698304,")
    assert all(r.endswith(",0") for r in rows[1:])
    bench_run.main(["--only", "dist_agg", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("===== distributed aggregation")
    assert out[2:2 + len(rows)] == rows
