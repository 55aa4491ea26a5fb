"""The fusion kernels' launch-shape search (``repro_torch.kernels.autotune``,
``build.SHAPES``) on the CPU: the fixed set of shapes the CUDA libraries
export, their encoding in the reference's ``bn`` / ``kb``, legality, the
closed-form ``autotune`` (deterministic, never worse than the default
shape), a port table with searched shapes loading in the reference, and
the wrappers taking ``bn`` / ``kb`` on the CPU with the plain result.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 3
holds each against its plain version at every legal shape, and phase 13
times every legal shape."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.kernels.autotune as jtune
from repro_torch.kernels import autotune as tune
from repro_torch.kernels import build, ops
from repro_torch.kernels.fused_agg import fused_agg
from repro_torch.kernels.pair_fuse import pair_fuse
from repro_torch.kernels.quant_agg import quant_agg
from repro_torch.kernels.ref import fused_agg_ref, pair_fuse_ref, quant_agg_ref

KERNELS = ("pair_fuse", "fused_agg", "quant_agg")
# sizes: one block, ragged and small, the main path's largest leaf, the
# cost table's largest row
SIZES = (1, 1000, 155_582_464, 375_816_192)


def test_shapes_are_the_libraries_set():
    """``build.SHAPES`` lists the pairs of csrc/common.cuh FOR_EACH_SHAPE."""
    src = (Path(build.CSRC) / "common.cuh").read_text()
    body = src[src.index("#define FOR_EACH_SHAPE"):]
    body = body[:body.index("\n\n")]
    pairs = {(int(v), int(t)) for v, t in re.findall(r"X\((\d+), (\d+)\)",
                                                     body)}
    assert pairs == set(build.SHAPES) and len(build.SHAPES) == 12
    assert set(build.DEFAULT_SHAPES) == set(KERNELS)
    assert all(s in build.SHAPES for s in build.DEFAULT_SHAPES.values())


@pytest.mark.parametrize("vec,threads", build.SHAPES)
def test_launch_shape_encoding_round_trips(vec, threads):
    for kernel in KERNELS:
        assert build.launch_shape(kernel, bn=vec * threads, kb=vec) == (
            vec, threads)


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_shape_defaults(kernel):
    vec, threads = build.DEFAULT_SHAPES[kernel]
    assert build.launch_shape(kernel) == (vec, threads)
    assert build.default_tile(kernel) == (vec * threads, vec)
    # one part named: the other is the default's
    assert build.launch_shape(kernel, bn=vec * 512) == (vec, 512)
    assert build.launch_shape(kernel, kb=16) == (16, threads)


@pytest.mark.parametrize("bn,kb", [(3000, 8), (2048, 2), (64, 4),
                                   (2048 * 16, 16), (4096, 3)])
def test_unknown_launch_shape_raises(bn, kb):
    with pytest.raises(ValueError, match="no exported launch shape"):
        build.launch_shape("fused_agg", bn, kb)


@pytest.mark.parametrize("itemsize", [None, 2])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_candidates_are_legal(kernel, n, itemsize):
    got = tune.candidates(kernel, 3, n, itemsize)
    assert got, "every problem has a legal shape"
    sizes = tune._itemsizes(kernel, itemsize)
    smallest = min(bn for bn, _ in got)
    for bn, kb in got:
        vec, threads = build.launch_shape(kernel, bn, kb)
        assert all(vec * s in (8, 16, 32, 64) for s in sizes)
        assert bn <= -(-n // smallest) * smallest
    # legality only: the same set whatever K is
    assert got == tune.candidates(kernel, 8, n, itemsize)


def test_candidates_by_dtype():
    # fp32 (and int8) operands: 4-element threads move 16 B of fp32 but
    # only 4 B of int8, so quant_agg has no 4-element shape
    assert {kb for _, kb in tune.candidates("quant_agg", 8, 10**8)} == {8, 16}
    assert {kb for _, kb in tune.candidates("fused_agg", 8, 10**8)} == {
        4, 8, 16}
    assert len(tune.candidates("pair_fuse", 2, 10**8, 2)) == 12
    # one block's worth: only blocks of 512 elements
    assert tune.candidates("fused_agg", 8, 100) == [(512, 4)]


@pytest.mark.parametrize("block_s,launch_s", [(0.0, 0.0), (1e-7, 5e-6),
                                              (-1e-9, 5e-6)])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_autotune_deterministic_never_worse_than_default(
        kernel, n, block_s, launch_s, monkeypatch):
    monkeypatch.setattr(tune, "BLOCK_S", block_s)
    monkeypatch.setattr(tune, "LAUNCH_S", launch_s)
    k = tune.KERNELS[kernel].k
    a, b = tune.autotune(kernel, k, n), tune.autotune(kernel, k, n)
    assert a == b
    assert (a.bn, a.kb) in tune.candidates(kernel, k, n)
    scores = {c: tune.modeled_time_s(kernel, k, n, bn=c[0], kb=c[1])
              for c in tune.candidates(kernel, k, n)}
    assert a.modeled_s == min(scores.values())
    if build.default_tile(kernel) in scores:
        assert a.modeled_s <= scores[build.default_tile(kernel)]
    assert a.bytes_moved == tune.kernel_bytes_moved(kernel, k, n)
    assert a.roofline_s == a.bytes_moved / 3.35e12
    assert a.modeled_s == a.roofline_s + tune.grid_steps(
        kernel, k, n, bn=a.bn, kb=a.kb) * block_s + launch_s


def test_autotune_score_follows_the_block_allowance(monkeypatch):
    n = 155_582_464
    monkeypatch.setattr(tune, "BLOCK_S", 1e-9)  # blocks cost: the largest
    assert (tune.autotune("fused_agg", 8, n).bn,) == (16384,)
    monkeypatch.setattr(tune, "BLOCK_S", -1e-12)  # blocks help: the least
    assert (tune.autotune("fused_agg", 8, n).bn,) == (512,)
    monkeypatch.setattr(tune, "BLOCK_S", 0.0)  # a tie: the default
    assert (tune.autotune("fused_agg", 8, n).bn,
            tune.autotune("fused_agg", 8, n).kb) == build.default_tile(
                "fused_agg")


@pytest.mark.parametrize("kernel,k,n,usize,want", [
    ("pair_fuse", 2, 1000, 2, 10_000),  # fp32 acc + bf16 update -> fp32
    ("fused_agg", 3, 1000, 2, 8_012),  # bf16 rows -> bf16
    ("quant_agg", 3, 1000, 1, 7_012),
])
def test_bytes_at_main_path_dtypes(kernel, k, n, usize, want):
    assert tune.kernel_bytes_moved(kernel, k, n, usize) == want
    assert tune.grid_steps(kernel, k, n, bn=512, kb=4) == 2


def _measured(kernel, n, bn, kb, graph):
    return tune.Measured(kernel, n, 8, 4, bn, kb, graph * 1.1, graph, 0.0)


def test_fit_block_s_and_best():
    n = 2**20
    # a thread's width costs on its own; the blocks 2 ns each
    rows = [_measured("fused_agg", n, bn, kb,
                      1e-4 + 1e-5 * kb + 2e-9 * (n // bn))
            for bn, kb in tune.candidates("fused_agg", 8, n)]
    assert tune.fit_block_s(rows) == pytest.approx(2e-9, rel=1e-6)
    assert (tune.best(rows).bn, tune.best(rows).kb) == (4096, 4)
    assert (tune.default_of(rows).bn, tune.default_of(rows).kb) == \
        build.default_tile("fused_agg")
    assert tune.default_of(rows[:1]) is None
    with pytest.raises(ValueError):
        tune.fit_block_s(rows[:2])


def test_searched_table_loads_in_the_reference(tmp_path):
    """A measured table's entries carry searched shapes in bn / kb; the
    reference's loader (``CostEntry(**e)``) takes it, with the same t_pair
    and tile at every size."""
    entries = [tune.CostEntry(kernel, mb, t, bn, kb, "measured")
               for kernel, (bn, kb) in zip(KERNELS, [(16384, 16), (512, 4),
                                                     (4096, 8)])
               for mb, t in ((52_428_800, 3e-5), (1_503_264_768, 6e-4))]
    table = tune.KernelCostTable(entries=entries)
    table.dump(tmp_path / "t.json")
    ref = jtune.KernelCostTable.load(str(tmp_path / "t.json"))
    ref2 = jtune.KernelCostTable.from_json(table.to_json())
    for kernel in KERNELS:
        for mb in (1, 52_428_800, 300_000_000, 4_000_000_000):
            assert ref.t_pair(mb, kernel) == table.t_pair(mb, kernel)
            assert ref2.tile(mb, kernel) == table.tile(mb, kernel)
            assert build.launch_shape(kernel, *table.tile(mb, kernel)) in \
                build.SHAPES


def _data(n=1003, k=3, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)),
            torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)),
            torch.from_numpy(rng.random(k).astype(np.float32)))


@pytest.mark.parametrize("vec,threads", build.SHAPES)
def test_wrappers_take_the_shape_on_the_cpu(vec, threads):
    a, b, u, q, w = _data()
    kw = dict(bn=vec * threads, kb=vec)
    assert torch.equal(pair_fuse(a, b, op="wsum", wa=0.3, wb=0.7, **kw),
                       pair_fuse_ref(a, b, "wsum", 0.3, 0.7))
    assert torch.equal(fused_agg(u, w, **kw), fused_agg_ref(u, w))
    assert torch.equal(quant_agg(q, w, **kw), quant_agg_ref(q, w))
    # the plain versions accept the same arguments and ignore them
    assert torch.equal(fused_agg_ref(u, w, **kw), fused_agg_ref(u, w))
    tree = [{"x": u[i].reshape(17, 59)} for i in range(3)]
    want = ops.fuse_updates(tree, [0.2, 0.3, 0.5])
    got = ops.fuse_updates(tree, [0.2, 0.3, 0.5], **kw)
    assert torch.equal(got["x"], want["x"])
    acc = ops.accumulate(tree[0], tree[1], 0.25, **kw)
    assert torch.equal(acc["x"], ops.accumulate(tree[0], tree[1], 0.25)["x"])
    qt = [{"x": q[i]} for i in range(3)]
    st = [{"x": w[i]} for i in range(3)]
    assert torch.equal(ops.fuse_quantized(qt, st, **kw)["x"],
                       ops.fuse_quantized(qt, st)["x"])


def test_wrappers_refuse_an_unknown_shape_on_the_cpu():
    a, b, u, q, w = _data()
    with pytest.raises(ValueError, match="no exported launch shape"):
        pair_fuse(a, b, bn=3000, kb=8)
    with pytest.raises(ValueError, match="no exported launch shape"):
        fused_agg(u, w, kb=32)
    with pytest.raises(ValueError, match="no exported launch shape"):
        ops.fuse_quantized([{"x": q[0]}], [{"x": w[0]}], bn=100)
