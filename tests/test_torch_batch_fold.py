"""The backlog fold ``batch_fold``, on the CPU: its plain version agrees bit
for bit with the same updates folded one at a time (``accumulate``, whose
route on the CPU is ``pair_fuse_ref``) at every width 1 to ``C_MAX``, for
a tree's first batch (no accumulator) and a later one, with fp32 and bf16
updates, a ragged last batch, one tensor twice in a batch, a misaligned
view and more leaves than one table takes. ``plan`` lays out the tables as
the CUDA kernel reads them, and the kernel's block-to-leaf search covers
every element once. The kernel itself is held against its plain version on
the card by ``chip_smoke.py``."""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.batch_fold import (C_MAX, TABLE_MAX, Operands,
                                            batch_fold, plan)
from repro_torch.kernels.ops import accumulate, accumulate_batch
from repro_torch.kernels.ref import batch_fold_ref

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
SIZES = (1000, 576, 33, 1, 20_000, 7)


def _leaves(rng, sizes, dtype, off=0):
    """Leaves of ``sizes`` elements in ``dtype``, each a view ``off``
    elements into its own buffer."""
    return [torch.from_numpy(rng.standard_normal(n + off, dtype=np.float32))
            .to(dtype)[off:] for n in sizes]


def _weights(rng, c):
    return [float(w) for w in rng.integers(100, 1001, c)]


def _streaming(acc, updates, weights):
    """The same fold one update at a time through ``accumulate``."""
    for u, w in zip(updates, weights):
        acc = accumulate(acc, u, w)
    return acc


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == F32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("start", [True, False], ids=["start", "fold"])
@pytest.mark.parametrize("c", range(1, C_MAX + 1))
def test_plain_version_is_the_streaming_fold(c, start, dtype):
    rng = np.random.default_rng(c)
    ups = [_leaves(rng, SIZES, dtype) for _ in range(c)]
    ws = _weights(rng, c)
    acc = None if start else _leaves(rng, SIZES, F32)
    want = _streaming(acc, ups, ws)
    ref = [batch_fold_ref(None if acc is None else acc[i],
                          [u[i] for u in ups], ws) for i in range(len(SIZES))]
    _same(ref, want)
    _same(batch_fold(acc, ups, ws), want)


def test_ragged_batches_in_place_are_the_streaming_fold():
    """13 updates as a batch of 8 that starts the accumulator and one of 5
    that updates it in place."""
    rng = np.random.default_rng(13)
    ups = [_leaves(rng, SIZES, BF16) for _ in range(13)]
    ws = _weights(rng, 13)
    acc = accumulate_batch(None, ups[:8], ws[:8])
    kept = list(acc)
    acc2 = accumulate_batch(acc, ups[8:], ws[8:], in_place=True)
    assert all(a is b for a, b in zip(acc2, kept))
    _same(acc2, _streaming(None, ups, ws))


def test_out_of_place_leaves_the_accumulator_alone():
    rng = np.random.default_rng(5)
    ups = [_leaves(rng, SIZES, BF16) for _ in range(3)]
    acc = _leaves(rng, SIZES, F32)
    frozen = [a.clone() for a in acc]
    got = batch_fold(acc, ups, [1.0, 2.0, 3.0])
    assert all(g is not a for g, a in zip(got, acc))
    _same(acc, frozen)


def test_repeated_and_misaligned_updates():
    """One update three times in a batch, every update a view one element
    off its buffer's start."""
    rng = np.random.default_rng(7)
    pool = [_leaves(rng, SIZES, BF16, off=1) for _ in range(4)]
    ups = [pool[0], pool[1], pool[0], pool[2], pool[3], pool[0], pool[1],
           pool[2]]
    ws = _weights(rng, 8)
    for acc in (None, _leaves(rng, SIZES, F32)):
        _same(batch_fold(acc, ups, ws), _streaming(acc, ups, ws))


def test_more_leaves_than_a_table():
    """300 leaves of bf16 (270) and fp32 (30) updates, an empty one among
    them: three tables, each the streaming fold's bits."""
    rng = np.random.default_rng(300)
    sizes = [int(n) for n in rng.integers(1, 3_000, 300)]
    sizes[77] = 0
    dts = [F32 if i % 10 == 0 else BF16 for i in range(300)]
    ups = [[torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(d)
            for n, d in zip(sizes, dts)] for _ in range(5)]
    ws = _weights(rng, 5)
    ops = [Operands(u.dtype, u.numel(), 0, 0, ()) for u in ups[0]]
    assert len(plan(ops, *build.DEFAULT_SHAPES["batch_fold"])) == 3
    for acc in (None, [torch.zeros(n) + 0.5 for n in sizes]):
        _same(batch_fold(acc, ups, ws), _streaming(acc, ups, ws))


def test_the_cpu_launches_nothing():
    rng = np.random.default_rng(1)
    ups = [_leaves(rng, SIZES, BF16) for _ in range(8)]
    before = (batch_fold.launches, batch_fold.updates)
    batch_fold(None, ups, [1.0] * 8)
    assert (batch_fold.launches, batch_fold.updates) == before


def _operands(seed=0, n_leaves=40, off_every=0):
    """Fake addresses of ``n_leaves`` leaves of 8 updates, each operand at
    its own 256-byte-aligned slot; with ``off_every`` every such leaf's
    third update sits one bf16 element off its vector's alignment."""
    rng = np.random.default_rng(seed)
    sizes = [int(n) for n in rng.integers(1, 40_000, n_leaves)]
    sizes[3] = 0
    sizes[6] = sizes[7]  # a tie keeps call order
    ops, at = [], 1 << 20
    for i, n in enumerate(sizes):
        du = F32 if i % 7 == 0 else BF16
        step = 256 * (-(-n * 4 // 256) + 1)
        ups = [at + (j + 2) * step for j in range(C_MAX)]
        if off_every and i % off_every == 1:
            ups[2] += du.itemsize
        ops.append(Operands(du, n, at, at + step, tuple(ups)))
        at += (C_MAX + 3) * step
    return ops


@pytest.mark.parametrize("kb, threads", [(4, 128), (8, 256), (16, 1024)])
def test_plan_lays_out_the_tables_the_kernel_reads(kb, threads):
    leaves = _operands(n_leaves=TABLE_MAX + 60, off_every=5)
    launches = plan(leaves, kb, threads)
    per_block = kb * threads
    seen, groups = [], {}
    for launch in launches:
        assert 1 <= len(launch.entries) <= TABLE_MAX
        groups.setdefault(launch.dtypes, []).append(launch)
        sizes = [leaves[e.pair].n for e in launch.entries]
        assert sizes == sorted(sizes, reverse=True)
        first = 0
        for e in launch.entries:
            p = leaves[e.pair]
            assert (F32, p.u_dtype) == launch.dtypes and p.n > 0
            assert e.first == first
            first += math.ceil(p.n / per_block)
            # csrc/common.cuh chunk_bytes: up to 16 bytes a vector
            align_a = min(kb * 4, 16)
            align_u = min(kb * p.u_dtype.itemsize, 16)
            assert e.vector == (p.acc % align_a == 0 and p.out % align_a == 0
                                and all(u % align_u == 0 for u in p.updates))
        assert launch.blocks == first
        seen += [e.pair for e in launch.entries]
    assert sorted(seen) == [i for i, p in enumerate(leaves) if p.n]
    for key, chunks in groups.items():
        count = sum(1 for p in leaves if p.n and p.u_dtype == key[1])
        assert len(chunks) == -(-count // TABLE_MAX)
        order = [e.pair for c in chunks for e in c.entries]
        assert order == sorted(order, key=lambda i: (-leaves[i].n, i))
    assert len(launches) == 3  # fp32 updates, then two tables of bf16
    flags = {e.pair: e.vector for la in launches for e in la.entries}
    assert not any(flags[i] for i in flags if i % 5 == 1)
    assert all(flags[i] for i in flags if i % 5 != 1)


def test_each_block_finds_its_leaf_and_covers_it_once():
    """The kernel's block-to-leaf search (csrc/batch_fold.cu: the last entry
    whose first block is at or before the block), over every block."""
    kb, threads = build.DEFAULT_SHAPES["batch_fold"]
    per_block = kb * threads
    leaves = _operands(seed=1)
    for launch in plan(leaves, kb, threads):
        firsts = [e.first for e in launch.entries]
        covered = {e.pair: 0 for e in launch.entries}
        for block in range(launch.blocks):
            lo, hi = 0, len(firsts) - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if firsts[mid] <= block:
                    lo = mid
                else:
                    hi = mid - 1
            e = launch.entries[lo]
            start = (block - e.first) * per_block
            assert start == covered[e.pair] < leaves[e.pair].n
            covered[e.pair] = min(start + per_block, leaves[e.pair].n)
        assert all(covered[i] == leaves[i].n for i in covered)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u = [torch.ones(4)]
    with pytest.raises(ValueError, match="1 to 8"):
        batch_fold(None, [], [])
    with pytest.raises(ValueError, match="1 to 8"):
        batch_fold(None, [u] * 9, [1.0] * 9)
    with pytest.raises(ValueError, match="1 to 8"):
        batch_fold(None, [u, u], [1.0])
    with pytest.raises(ValueError, match="in place"):
        batch_fold(None, [u], [1.0], in_place=True)
    with pytest.raises(ValueError, match="number of leaves"):
        batch_fold([torch.ones(4), torch.ones(2)], [u], [1.0])
    with pytest.raises(ValueError, match="one shape"):
        batch_fold(None, [u, [torch.ones(5)]], [1.0, 1.0])
    with pytest.raises(ValueError, match="shares memory"):
        acc = torch.zeros(8)
        batch_fold([acc[:4]], [[acc[2:6]]], [1.0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        batch_fold(None, [[torch.empty(4, device="meta")]], [1.0])
    with pytest.raises(ValueError, match="no exported launch shape"):
        batch_fold(None, [u], [1.0], bn=3000, kb=8)


def test_constants_are_the_kernel_source_s():
    """C_MAX, TABLE_MAX and the row of csrc/batch_fold.cu; the table passed
    by value fits the 32,764 bytes of kernel parameters."""
    src = (build.CSRC / "batch_fold.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(const["C_MAX"]) == C_MAX
    assert int(const["TABLE_MAX"]) == TABLE_MAX
    assert const["ROW"] == "2 + C_MAX + 3"
    leaf = 8 + 8 + 8 * C_MAX + 8 + 4 + 4
    assert TABLE_MAX * leaf + 4 * C_MAX + 4 + 4 <= 32_764
    assert build.DEFAULT_SHAPES["batch_fold"] in build.SHAPES
