"""Helpers of ``test_torch_layout.py``: one step's collectives on a 2 x 2
layout in each package.

The reference's side compiles the step (``repro.launch.steps.build``)
for a concrete 2 x 2 ``jax.sharding.Mesh`` of ``conftest.py``'s virtual
devices and reads the partitioned HLO: ``collective_bytes`` gives its
counts and bytes (the TPU-adjusted column: each f32 collective counted at
bf16 width), and ``param_gathers`` its all-gathers of parameters, those
whose operand is a model parameter of the step's entry computation,
through ops that only convert, reshape, slice, copy or permute it (the
classifier of ``scripts/torch_collectives_vs_reference.py``). The port's side
runs the step on DTensors over a 4-rank layout-only group
(``repro_torch.launch.layout``), whose ``CollectiveRecord`` tells the
gathers of parameter blocks apart by their storage.
"""
import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "torch_collectives_vs_reference",
    Path(__file__).resolve().parents[1] / "scripts"
    / "torch_collectives_vs_reference.py")
_vs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_vs)
param_gathers = _vs.param_gathers


def reference_step(arch: str, kind: str, batch: int = 8, seq: int = 64,
                   profile: str = "baseline", over=None):
    """The reference's reduced step (``reduced(**over)``) at B x S on a
    concrete 2 x 2 mesh under ``profile``: (collective_bytes's (total,
    by_kind, counts, total_tpu), its parameter all-gathers (count,
    TPU-adjusted bytes))."""
    import jax
    from jax.sharding import Mesh

    from repro import configs
    from repro.configs.base import InputShape
    from repro.launch import sharding as shd
    from repro.launch import steps
    from repro.launch.dryrun import collective_bytes
    from repro.models import model as M
    from repro.models.sharding_ctx import activation_sharding

    configs.load_all()
    cfg = configs.get_config(arch).reduced(**(over or {}))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    shape = InputShape("t", seq, batch, kind)
    fn, args, in_sh, donate = steps.build(cfg, shape, mesh, profile)
    with activation_sharding(mesh, shd.activation_rules(
            mesh, cfg.sequence_parallel), profile=profile):
        hlo = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate).lower(
            *args).compile().as_text()
    n_params = len(jax.tree_util.tree_leaves(M.param_specs(cfg)))
    return collective_bytes(hlo), param_gathers(hlo, n_params)


def port_step(arch: str, kind: str, batch: int = 8, seq: int = 64,
              profile: str = "baseline", mesh_shape=(2, 2), over=None):
    """The port's reduced step (``reduced(**over)``) at B x S on a
    ``mesh_shape`` layout-only group: its ``CollectiveRecord``. Starts and
    ends the group."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import layout
    from repro_torch.launch.mesh import make_host_mesh

    configs.load_all()
    cfg = configs.get_config(arch).reduced(**(over or {}))
    with layout.layout_group(mesh_shape[0] * mesh_shape[1]):
        mesh = make_host_mesh(*mesh_shape)
        fn, dargs = layout.build_on_mesh(cfg, InputShape("t", seq, batch,
                                                         kind), mesh, profile)
        _, record = layout.run_step(fn, dargs, mesh, cfg, profile)
    return record


# (arch, kind): ((port parameter gathers: count, bytes), (the reference's),
# port counts by kind, the reference's), kinds in layout.KINDS order
STEPS = {
    ("recurrentgemma-9b", "train"): ((48, 3809280), (40, 3801088), (63, 41, 38, 30, 0), (45, 33, 0, 2, 7)),
    ("recurrentgemma-9b", "prefill"): ((21, 2031616), (21, 2031616), (25, 5, 4, 8, 0), (22, 8, 0, 1, 3)),
    ("recurrentgemma-9b", "decode"): ((20, 1900544), (18, 1835008), (28, 8, 4, 9, 0), (20, 13, 0, 1, 3)),
    ("qwen1.5-4b", "train"): ((16, 1441792), (16, 1441792), (21, 20, 10, 0, 0), (17, 12, 0, 2, 1)),
    ("qwen1.5-4b", "prefill"): ((9, 851968), (9, 851968), (9, 3, 0, 0, 0), (10, 2, 0, 1, 1)),
    ("qwen1.5-4b", "decode"): ((8, 720896), (8, 720896), (10, 3, 0, 1, 0), (10, 3, 0, 1, 1)),
    ("qwen3-0.6b", "train"): ((16, 1441792), (16, 1441792), (19, 21, 10, 0, 0), (17, 13, 0, 2, 1)),
    ("qwen3-0.6b", "prefill"): ((9, 851968), (9, 851968), (9, 3, 0, 0, 0), (10, 2, 0, 1, 1)),
    ("qwen3-0.6b", "decode"): ((8, 720896), (8, 720896), (10, 3, 0, 1, 0), (10, 3, 0, 1, 1)),
    ("llama-3.2-vision-90b", "train"): ((72, 6160384), (72, 6160384), (83, 57, 38, 0, 0), (73, 45, 0, 2, 1)),
    ("llama-3.2-vision-90b", "prefill"): ((37, 3211264), (37, 3211264), (37, 11, 0, 0, 0), (38, 10, 0, 1, 1)),
    ("llama-3.2-vision-90b", "decode"): ((34, 3014656), (34, 3014656), (39, 11, 0, 1, 0), (39, 11, 0, 1, 1)),
    ("mamba2-130m", "train"): ((14, 1116160), (14, 1116160), (19, 21, 12, 7, 0), (15, 12, 0, 2, 7)),
    ("mamba2-130m", "prefill"): ((8, 689152), (8, 689152), (9, 2, 1, 0, 0), (9, 2, 0, 1, 3)),
    ("mamba2-130m", "decode"): ((7, 558080), (5, 525312), (9, 2, 1, 1, 0), (6, 4, 0, 1, 3)),
    ("musicgen-large", "train"): ((19, 2228224), (20, 2752512), (22, 20, 13, 0, 0), (24, 12, 0, 5, 4)),
    ("musicgen-large", "prefill"): ((12, 1638400), (12, 1638400), (12, 3, 0, 0, 0), (16, 2, 0, 4, 4)),
    ("musicgen-large", "decode"): ((8, 1114112), (8, 1114112), (13, 3, 0, 1, 0), (13, 3, 0, 4, 4)),
    ("minitron-8b", "train"): ((16, 1441792), (16, 1441792), (19, 17, 10, 0, 0), (17, 13, 0, 2, 1)),
    ("minitron-8b", "prefill"): ((9, 851968), (9, 851968), (9, 3, 0, 0, 0), (10, 2, 0, 1, 1)),
    ("minitron-8b", "decode"): ((8, 720896), (8, 720896), (10, 3, 0, 1, 0), (10, 3, 0, 1, 1)),
    ("llama4-scout-17b-a16e", "train"): ((24, 4591616), (23, 4067328), (31, 24, 15, 0, 0), (31, 20, 0, 5, 11)),
    ("llama4-scout-17b-a16e", "prefill"): ((13, 2426880), (12, 1902592), (13, 6, 0, 0, 0), (15, 5, 0, 2, 4)),
    ("llama4-scout-17b-a16e", "decode"): ((12, 2295808), (10, 1769472), (14, 6, 0, 1, 0), (14, 7, 0, 2, 5)),
    ("qwen2.5-14b", "train"): ((16, 1441792), (16, 1441792), (21, 20, 10, 0, 0), (17, 12, 0, 2, 1)),
    ("qwen2.5-14b", "prefill"): ((9, 851968), (9, 851968), (9, 3, 0, 0, 0), (10, 2, 0, 1, 1)),
    ("qwen2.5-14b", "decode"): ((8, 720896), (8, 720896), (10, 3, 0, 1, 0), (10, 3, 0, 1, 1)),
    ("qwen2-moe-a2.7b", "train"): ((24, 4591616), (24, 4591616), (33, 27, 15, 0, 0), (27, 20, 0, 2, 11)),
    ("qwen2-moe-a2.7b", "prefill"): ((13, 2426880), (13, 2426880), (13, 6, 0, 0, 0), (15, 5, 0, 1, 5)),
    ("qwen2-moe-a2.7b", "decode"): ((12, 2295808), (10, 1769472), (14, 6, 0, 1, 0), (14, 7, 0, 2, 5)),
}
# where the parameter all-gathers part, (port - reference) as (count,
# bytes), with the cause
DIFFER = {
    # the causal conv's four f32 taps of each RG-LRU layer, d_inner-split,
    # gathered again in the port's backward
    ("recurrentgemma-9b", "train"): ((8, 8 * 1024), "conv taps"),
    # decode: the one KV head's wk / wv, which cannot follow the query
    # heads over the model axis, gathered where XLA sums partial products
    ("recurrentgemma-9b", "decode"): ((2, 2 * 32768), "decode wk/wv"),
    # decode: mamba2's w_B / w_C (d_model x N), likewise
    ("mamba2-130m", "decode"): ((2, 2 * 16384), "decode w_B/w_C"),
    # the reference gathers the 4-codebook LM head again for the
    # backward's product; the port's backward reuses its forward's block
    ("musicgen-large", "train"): ((-1, -524288), "LM head again"),
    # the experts' w_down: gathered by the port, where XLA gathers the
    # (sequence-parallel) activation instead; in decode also the router
    ("llama4-scout-17b-a16e", "train"): ((1, 524288), "w_down"),
    ("llama4-scout-17b-a16e", "prefill"): ((1, 524288), "w_down"),
    ("llama4-scout-17b-a16e", "decode"): ((2, 524288 + 2048),
                                          "w_down, router"),
    ("qwen2-moe-a2.7b", "decode"): ((2, 524288 + 2048), "w_down, router"),
}

# the optimized profile's expert-parallel MoE branch (the experts split
# over the model axis on both sides), as STEPS
OPT_STEPS = {
    ("qwen2-moe-a2.7b", "train"): ((18, 1445888), (18, 1445888), (29, 25, 14, 9, 0), (25, 17, 0, 14, 1)),
    ("qwen2-moe-a2.7b", "prefill"): ((10, 854016), (13, 2426880), (13, 4, 0, 3, 0), (14, 2, 0, 4, 2)),
    ("qwen2-moe-a2.7b", "decode"): ((0, 0), (0, 0), (1, 4, 0, 3, 0), (1, 3, 0, 3, 0)),
}
OPT_DIFFER = {
    # prefill: the three expert weights, (d_model / data, d_ff / model)
    # as parameters, go to the branch's (experts / model): DTensor moves
    # them by an all-to-all over the model axis and then an all-gather
    # over the data axis (the same 3 x 524,288 bytes gathered, but of the
    # all-to-all's output, so not a parameter's block), where XLA gathers
    # each parameter first
    ("qwen2-moe-a2.7b", "prefill"): ((-3, -3 * 524288), "experts moved "
                                     "by all-to-all, then gathered"),
}


def check_step(arch, kind, profile="baseline"):
    """One reduced step's collectives on both sides against ``STEPS``
    (and ``DIFFER``), or under the optimized profile ``OPT_STEPS`` (and
    ``OPT_DIFFER``)."""
    import torch.distributed as dist

    from repro_torch.launch import layout

    steps, differ = ((STEPS, DIFFER) if profile == "baseline"
                     else (OPT_STEPS, OPT_DIFFER))
    port, ref, port_counts, ref_counts = steps[(arch, kind)]
    record = port_step(arch, kind, profile=profile)
    (_, _, counts, _), ref_gathers = reference_step(arch, kind,
                                                    profile=profile)
    assert record.param_gathers() == port
    assert ref_gathers == ref
    assert tuple(record.counts()[k] for k in layout.KINDS) == port_counts
    assert tuple(counts[k] for k in layout.KINDS) == ref_counts
    if (arch, kind) in differ:
        (dn, db), _ = differ[(arch, kind)]
        assert (port[0] - ref[0], port[1] - ref[1]) == (dn, db)
    else:
        assert port == ref
    assert not dist.is_initialized()
    return record
