"""The port's analytic roofline (``repro_torch.launch.roofline``) against the
JAX package's, on the CPU: ``step_counts`` and ``analytic_roofline`` equal
``==`` for the 10 ``ARCH_IDS`` x 4 ``INPUT_SHAPES`` and for every (config,
batch, length) that ``chip_smoke.py`` phases 4, 11 and 12 run; the H100's
figures; ``roofline_report.fmt_row``; and the reference's decode-context
cap, copied and witnessed against the FLOPs the port's decode step does.

The comparison builds the port's ``HardwareSpec`` from the fields of the
reference's ``V5E``, and the reference's from the port's ``H100``, so that
both directions are held with the same figures.
"""
import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.configs.base import InputShape as JInputShape
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch import roofline_report as jreport
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun, mesh, roofline, roofline_report, steps

jconfigs.load_all()
configs.load_all()

FIELDS = ("peak_flops_bf16", "hbm_bw", "ici_link_bw", "hbm_bytes", "dcn_bw")
PORT_HW_FROM_REF = mesh.HardwareSpec(**dataclasses.asdict(jmesh.V5E))
REF_HW_FROM_PORT = jmesh.HardwareSpec(
    **{f: getattr(mesh.H100, f) for f in FIELDS})

# (config, layers or None for full depth, shape kind, batch, length): the
# runs of chip_smoke.py phase 4 (local training, batches of 8 x 64),
# phase 11 (train.main, 8 x 128; prefill of 1,024 and decode at 1,152
# slots, llama4-scout-17b-a16e at 4 of 48 layers) and phase 12 (local
# training; prefill and decode)
PHASE_RUNS = (
    ("qwen3-0.6b", None, "train", 8, 64),
    ("qwen3-0.6b", None, "train", 8, 128),
    ("qwen3-0.6b", None, "prefill", 8, 1024),
    ("qwen3-0.6b", None, "decode", 8, 1152),
    ("qwen2.5-14b", None, "prefill", 4, 1024),
    ("qwen2.5-14b", None, "decode", 4, 1152),
    ("qwen2-moe-a2.7b", None, "prefill", 4, 1024),
    ("qwen2-moe-a2.7b", None, "decode", 4, 1152),
    ("llama4-scout-17b-a16e", 4, "prefill", 4, 1024),
    ("llama4-scout-17b-a16e", 4, "decode", 4, 1152),
    ("mamba2-130m", 24, "train", 8, 64),
    ("recurrentgemma-9b", 3, "train", 8, 64),
    ("musicgen-large", 6, "train", 8, 64),
    ("mamba2-130m", None, "prefill", 8, 1024),
    ("mamba2-130m", None, "decode", 8, 1152),
    ("recurrentgemma-9b", None, "prefill", 4, 1024),
    ("recurrentgemma-9b", None, "decode", 4, 1152),
    ("musicgen-large", None, "prefill", 4, 1024),
    ("musicgen-large", None, "decode", 4, 1152),
    ("llama-3.2-vision-90b", 5, "prefill", 4, 1024),
    ("llama-3.2-vision-90b", 5, "decode", 4, 1152),
)


def _both(name, layers=None):
    port, ref = configs.get_config(name), jconfigs.get_config(name)
    if layers is not None:
        port = dataclasses.replace(port, num_layers=layers)
        ref = dataclasses.replace(ref, num_layers=layers)
    return port, ref


def _assert_same(port_cfg, ref_cfg, shape, jshape, chips, coll):
    assert (dataclasses.asdict(roofline.step_counts(port_cfg, shape))
            == dataclasses.asdict(jroof.step_counts(ref_cfg, jshape)))
    # the reference's figures in the port, and the port's in the reference
    assert (dataclasses.asdict(roofline.analytic_roofline(
                port_cfg, shape, chips, coll, PORT_HW_FROM_REF))
            == dataclasses.asdict(jroof.analytic_roofline(
                ref_cfg, jshape, chips, coll)))
    assert (dataclasses.asdict(roofline.analytic_roofline(
                port_cfg, shape, 1, 0.0))
            == dataclasses.asdict(jroof.analytic_roofline(
                ref_cfg, jshape, 1, 0.0, REF_HW_FROM_PORT)))


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_step_counts_and_roofline_equal_reference(arch, shape_name):
    port, ref = _both(arch)
    _assert_same(port, ref, INPUT_SHAPES[shape_name], JSHAPES[shape_name],
                 256, 3.5e9)


@pytest.mark.parametrize("name,layers,kind,batch,length", PHASE_RUNS)
def test_roofline_of_chip_smoke_runs_equals_reference(name, layers, kind,
                                                      batch, length):
    port, ref = _both(name, layers)
    _assert_same(port, ref, InputShape("run", length, batch, kind),
                 JInputShape("run", length, batch, kind), 1, 0.0)


def test_h100_figures_and_n_chips():
    h = mesh.H100
    assert (h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12,
                                                          80e9)
    assert h.peak_flops_fp32 == 67e12
    assert roofline.bandwidth_time_s(3.35e12) == 1.0
    assert mesh.n_chips(1) == 1 and mesh.n_chips(4) == 4
    # one card: the collective term is 0 and never the dominant one
    r = roofline.analytic_roofline(configs.get_config("qwen3-0.6b"),
                                   INPUT_SHAPES["train_4k"], 1, 0.0)
    assert r.collective_s == 0.0 and r.dominant == "memory"


def test_n_chips_of_a_device_mesh(tmp_path):
    """A one-rank gloo group over a file store (no port): its DeviceMesh
    counts one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert mesh.n_chips(init_device_mesh("cpu", (1,))) == 1
    finally:
        dist.destroy_process_group()


def test_fmt_row_matches_reference(monkeypatch):
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda a: full(a).reduced())
    row = dryrun.run_one("qwen3-0.6b", "decode_32k", verbose=False)
    assert roofline_report.fmt_row(row) == jreport.fmt_row(row)
    failed = {"arch": "qwen3-0.6b", "shape": "train_4k", "ok": False}
    assert roofline_report.fmt_row(failed) == jreport.fmt_row(failed)
    assert roofline_report.efficiency(row) == jreport.efficiency(row)


SWA = [a for a in configs.ARCH_IDS
       if configs.get_config(a).long_context == "swa"]


@pytest.mark.parametrize("arch", SWA)
def test_decode_context_cap_copied_and_witnessed(arch):
    """The reference caps a decode's attended context at ``swa_window``
    (8,192) for every ``swa`` config and decode shape
    (``src/repro/launch/roofline.py:58-62``), while ``decode_capacity``
    gives ``decode_32k`` all 32,768 slots, which ``cache_bytes`` counts.
    The port copies it. The port's decode step attends every slot: the
    FLOPs it counts at 32,768 slots exceed those at 8,192 by exactly 3 x
    the analytic attention term, so its attention FLOPs are exactly 4 x
    the analytic term (both are linear in the slots; nothing else in the
    step depends on them)."""
    port, ref = _both(arch)
    shape = INPUT_SHAPES["decode_32k"]
    assert shape.seq_len == 32_768 and port.swa_window == 8_192
    c = roofline.step_counts(port, shape)
    assert c.fwd_flops == jroof.step_counts(ref, JSHAPES["decode_32k"]
                                            ).fwd_flops

    # the analytic attention term at the capped context
    t = shape.global_batch
    attn_blocks = [bt for bt in port.block_types()
                   if bt in ("attn", "lattn", "moe")]
    assert "lattn" not in attn_blocks
    a_term = len(attn_blocks) * 2 * t * port.swa_window * port.num_heads \
        * port.head_dim * 2

    def counted(slots):
        fn, args, _ = steps.build(port, InputShape("decode_32k", slots, t,
                                                   "decode"))
        return dryrun.counted_flops(fn, *args)[1]

    assert counted(32_768) - counted(8_192) == 3 * a_term

    # cache_bytes uses all 32,768 slots, as the port's decode cache holds
    assert steps.decode_capacity(port, shape) == 32_768
    kv = len(attn_blocks) * 2 * t * 32_768 * port.num_kv_heads \
        * port.head_dim * roofline.BF16
    img = sum(2 * t * port.num_image_tokens * port.num_kv_heads
              * port.head_dim * roofline.BF16
              for bt in port.block_types() if bt == "xattn")
    assert c.cache_bytes == kv + img
    _, args, _ = steps.build(port, shape)
    slots = {x.shape[-3] for k, x in _leaves_with_keys(args[1]) if k == "k"
             and x.dim() == 5 and x.shape[-3] != port.num_image_tokens}
    assert slots == {32_768}


def _leaves_with_keys(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, k)
    elif isinstance(tree, torch.Tensor):
        yield key, tree
