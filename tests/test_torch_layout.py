"""The production layout's collectives (``repro_torch.launch.layout``) on a
layout-only (``fake``) process group in this process, held against the
reference's partitioned HLO.

* The layout itself: a 1 x 1 layout runs no collective; a redistribution
  that swaps two split dims is one all-to-all a mesh dim, counted as such
  (DTensor runs it as an all-gather and a chunk on a "cpu" mesh); at 16 x
  16, qwen3-0.6b's parameters are gathered leaf by leaf, per use.
* One SwiGLU block (``layers.mlp_apply``, d 256, d_ff 1,024, x (8, 64,
  256) bf16 split over the batch, weights by ``PARAM_RULES``) on 2 x 2: its
  forward's three weight all-gathers and its one all-reduce (the output
  laid out over the batch) equal the reference's, in count and in
  TPU-adjusted bytes (each f32 collective of the CPU's HLO counted at
  bf16 width). With the backward they part, and both sides are asserted:
  XLA all-reduces the weight gradients where the port reduce-scatters
  each onto its parameter's blocks.
* Each reduced ``ARCH_IDS`` x {prefill, decode} at B 8 x 64 on 2 x 2
  (``test_torch_layout_train.py`` has train): the parameter all-gathers
  (count, TPU-adjusted bytes) and the count of each collective kind,
  computed on both sides here, equal ``STEPS``'s entry. Where the two
  partitioners gather the same parameters (22 of the 30 combinations),
  the parameter all-gathers are equal; ``DIFFER`` names the other eight
  and their cause (``PERF.md``, "The collectives against the
  reference"). The other kinds differ by design: the port reduce-scatters
  where XLA all-reduces, and XLA adds collective-permutes the port never
  needs.
* The launchers: ``train --force-host`` steps dry and prints collectives
  and no loss.

Tolerance: none; counts and bytes are integers and agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from _torch_layout import DIFFER, STEPS, check_step, port_step
from repro.launch import sharding as jshd
from repro.launch.dryrun import collective_bytes as j_collective_bytes
from repro.models import layers as JL
from repro_torch import configs, tree_leaves
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, layout, train
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.spec import abstract_params

configs.load_all()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_step_collectives_against_the_reference(arch, kind):
    check_step(arch, kind)


def test_differences_are_few():
    assert len(STEPS) == 30 and len(DIFFER) == 8
    assert sum(p == r for p, r, _, _ in STEPS.values()) == 22


# --------------------------------------------------------------------------
# the layout itself
# --------------------------------------------------------------------------
def test_one_by_one_layout_has_no_collectives():
    record = port_step("qwen3-0.6b", "train", mesh_shape=(1, 1))
    assert record.items == [] and record.total_bytes() == 0


def test_swap_of_split_dims_counts_as_all_to_all():
    """Moving a split from dim 0 to dim 1 over one mesh dim is one
    all-to-all, whose output is the rank's new block: DTensor runs it on a
    "cpu" mesh as an all-gather and a chunk, which the record counts as
    the all-to-all the layout asked for."""
    from torch.distributed.tensor import Replicate, Shard

    with layout.layout_group(4):
        mesh = make_host_mesh(2, 2)
        sh = shd.NamedSharding(mesh, ("data", None))
        t = layout.distribute_one(torch.empty(8, 12, device="meta"), sh,
                                  mesh)
        record = layout.CollectiveRecord()
        with record:
            out = t.redistribute(mesh, (Shard(1), Replicate()))
    assert out.placements == (Shard(1), Replicate())
    assert [(c.kind, c.nbytes, c.group_size) for c in record.items] == [
        ("all-to-all", 8 * 6 * 4, 2)]


def test_production_parameters_gathered_per_leaf_and_use():
    """qwen3-0.6b x decode_32k on 16 x 16: 197 parameter gathers, one for
    each use of a parameter's block (seven a layer, 28 layers, and the LM
    head), none larger than one layer's largest weight block; the cache
    is never gathered."""
    cfg = configs.get_config("qwen3-0.6b")
    shape = INPUT_SHAPES["decode_32k"]
    with layout.layout_group(256):
        mesh = make_production_mesh()
        fn, dargs = layout.build_on_mesh(cfg, shape, mesh)
        _, record = layout.run_step(fn, dargs, mesh, cfg)
    gathers = [c for c in record.items if c.param]
    assert len(gathers) == 7 * cfg.num_layers + 1 == 197
    whole = sum(x.numel() * x.element_size()
                for x in tree_leaves(abstract_params(M.param_specs(cfg))))
    largest = max(c.nbytes for c in gathers)
    assert largest == cfg.d_model * cfg.vocab_size // 16 * 2  # LM head
    assert all(c.nbytes < whole / 50 for c in gathers)
    sites = {c.site.split(":")[0] for c in gathers}
    assert sites == {"models/attention.py", "models/layers.py",
                     "models/model.py"}
    # the cache (8 KV heads, which do not divide over 16) stays split along
    # its keys: the softmax is distributed over the key blocks, and no
    # other collective moves as much as a hundredth of a layer's K block
    k = max(tree_leaves(dargs[1]), key=lambda x: x.numel())
    layer_k = k.to_local().numel() * k.element_size() // cfg.num_layers
    assert max(c.nbytes for c in record.items if not c.param) < layer_k / 100


# --------------------------------------------------------------------------
# one SwiGLU block
# --------------------------------------------------------------------------
def _reference_mlp(backward: bool):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = JL.mlp_specs(256, 1024)
    p_sh = jshd.tree_shardings(specs, mesh, jshd.PARAM_RULES)
    x_sh = JNamedSharding(mesh, P("data", None, None))
    args = ({k: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
             for k, s in specs.items()},
            jax.ShapeDtypeStruct((8, 64, 256), jnp.bfloat16))
    fn = JL.mlp_apply
    if backward:
        fn = jax.grad(lambda p, x: JL.mlp_apply(p, x).astype(
            jnp.float32).sum())
    hlo = jax.jit(fn, in_shardings=(p_sh, x_sh)).lower(*args).compile(
        ).as_text()
    total, by_kind, counts, total_tpu = j_collective_bytes(hlo)
    return counts, total_tpu


def _port_mlp(backward: bool):
    from torch.distributed.tensor import Replicate, Shard

    with layout.layout_group(4):
        mesh = make_host_mesh(2, 2)
        specs = layers.mlp_specs(256, 1024)
        p = layout.distribute(abstract_params(specs), shd.tree_shardings(
            specs, mesh, shd.PARAM_RULES), mesh)
        x = layout.distribute_one(
            torch.empty(8, 64, 256, dtype=torch.bfloat16, device="meta"),
            shd.NamedSharding(mesh, ("data", None, None)), mesh)

        def fwd(p, x):  # the output laid out over the batch
            return layers.mlp_apply(p, x).redistribute(
                mesh, (Shard(0), Replicate()))

        def fwd_bwd(p, x):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            loss = fwd(leaves, x).float().sum()
            return torch.autograd.grad(loss, list(leaves.values()))

        _, record = layout.run_step(fwd_bwd if backward else fwd, (p, x),
                                    mesh, configs.get_config("qwen3-0.6b"))
    return record


def test_swiglu_forward_equals_the_reference():
    record = _port_mlp(False)
    counts, total_tpu = _reference_mlp(False)
    assert record.counts() == counts == {
        "all-gather": 3, "all-reduce": 1, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    # three d_model-gathered weights of 256 x 512 and one (4, 64, 256)
    # output, all bf16
    assert record.total_bytes() == total_tpu == 3 * 262144 + 131072
    assert record.param_gathers() == (3, 3 * 262144)


def test_swiglu_backward_parts_as_designed():
    record = _port_mlp(True)
    counts, total_tpu = _reference_mlp(True)
    # the port: the forward's, then each weight gradient reduce-scattered
    # onto its blocks (128 x 512 bf16)
    assert record.counts() == {"all-gather": 3, "all-reduce": 1,
                               "reduce-scatter": 3, "all-to-all": 0,
                               "collective-permute": 0}
    assert record.total_bytes() == 3 * 262144 + 131072 + 3 * 131072
    # XLA: the same gathers, and the weight gradients all-reduced whole in
    # one merged all-reduce
    assert counts == {"all-gather": 3, "all-reduce": 1, "reduce-scatter": 0,
                      "all-to-all": 0, "collective-permute": 0}
    assert total_tpu == 3 * 262144 + 3 * 262144


# --------------------------------------------------------------------------
# the dry run and the launcher on the layout
# --------------------------------------------------------------------------
def test_collective_bytes_of_a_record():
    record = port_step("qwen3-0.6b", "decode")
    total, by_kind, counts, total_tpu = dryrun.collective_bytes(record)
    assert total == total_tpu == record.total_bytes()
    assert counts == record.counts() and by_kind == record.bytes_by_kind()
    assert dryrun._shape_bytes((2, 16, 4096), torch.bfloat16) == \
        dryrun._shape_bytes((2, 16, 4096), "bfloat16") == 2 * 16 * 4096 * 2


def test_force_host_steps_dry(capsys):
    assert train.main(["--arch", "qwen3-0.6b", "--reduced", "--force-host",
                       "--steps", "2", "--batch", "16", "--seq-len",
                       "32"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2 and all("collectives {" in ln for ln in lines)
    assert "'all-gather': " in lines[0] and "loss=" not in out
    assert not dist.is_initialized()


def test_collectives_by_site_groups_the_record():
    """The core of ``scripts/torch_analyze_collectives.py``: rows of
    (bytes, kind, shape, cnt, trip, site), largest first, whose bytes and
    trips add up to the record's."""
    record = port_step("qwen3-0.6b", "prefill")
    rows = dryrun.collectives_by_site(record, top=1000)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert sum(r[0] for r in rows) == record.total_bytes()
    assert sum(r[4] for r in rows) == len(record.items)
    assert all(r[3] == 1 and r[1] in layout.KINDS for r in rows)
    assert any(r[5].startswith("models/layers.py:") for r in rows)
    assert len(dryrun.collectives_by_site(record, top=3)) == 3


def test_report_sets_the_meshes_side_by_side(tmp_path, monkeypatch, capsys):
    """``roofline_report --collectives``: one row an (arch, shape), each
    production mesh's bytes and counts by kind."""
    import json

    from repro_torch.launch import roofline_report

    monkeypatch.setattr(roofline_report, "RESULTS", tmp_path)
    counts = dict(zip(layout.KINDS, (3, 2, 1, 0, 0)))
    for mesh, nbytes in (("16x16", 1.5e9), ("2x16x16", 2.5e9)):
        (tmp_path / f"x__{mesh}.json").write_text(json.dumps({
            "arch": "qwen3-0.6b", "shape": "decode_32k", "mesh": mesh,
            "profile": "baseline", "ok": True, "collective_counts": counts,
            "collective_bytes_per_device": nbytes}))
    roofline_report.main(["--collectives"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("| qwen3")]
    assert rows == ["| qwen3-0.6b | decode_32k | 1.500e+09 | 3 / 2 / 1 / 0 "
                    "/ 0 | 2.500e+09 | 3 / 2 / 1 / 0 / 0 |"]
