"""The table ``pair_fuse`` launches, on the CPU: ``plan`` lays out the
pairs of a ``pair_fuse_many`` call as the CUDA kernel reads them (one
launch a dtype pair and chunk of at most ``TABLE_MAX``, largest first, the
first blocks end to end, the vector flag per pair), and the blocks of each
table, each finding its pair by the kernel's binary search, cover every
element of every pair once. ``pair_fuse_many`` on the same pairs equals
``pair_fuse_ref`` pair by pair. The kernel itself is held against
``pair_fuse_ref`` on the card by ``chip_smoke.py``.

The cases: one pair; mamba2-130m's 17 leaves (fp32 accumulator, bf16
update), as the fold makes them; 70 pairs of the three dtype pairs (65
non-empty fp32 + bf16 ones: two tables), some empty, some at addresses off
their vector's alignment."""
import math

import numpy as np
import pytest
import torch

from repro_torch import configs, tree_leaves
from repro_torch.kernels import build
from repro_torch.kernels.pair_fuse import (TABLE_MAX, Operands, pair_fuse,
                                           pair_fuse_many, plan)
from repro_torch.kernels.ref import pair_fuse_ref
from repro_torch.models import model as M

torch.set_num_threads(1)
configs.load_all()

F32, BF16 = torch.float32, torch.bfloat16


def _mamba_sizes():
    cfg = configs.get_config("mamba2-130m")
    return [math.prod(s.shape) for s in tree_leaves(M.param_specs(cfg))]


def _case(name):
    """(dtypes, sizes, misaligned) of the case's pairs: ``misaligned[i]``
    starts pair i's ``b`` one element off its vector's alignment."""
    if name == "one":
        return [(F32, BF16)], [1_000_003], [False]
    if name == "mamba2-130m":
        sizes = _mamba_sizes()
        return [(F32, BF16)] * len(sizes), sizes, [False] * len(sizes)
    rng = np.random.default_rng(70)
    sizes = [int(s) for s in rng.integers(1, 20_000, 70)]
    for i in (3, 30, 40):
        sizes[i] = 0
    sizes[5] = sizes[6]  # a tie keeps call order
    dts = [(F32, BF16)] * 70
    dts[10], dts[20], dts[30] = (F32, F32), (BF16, BF16), (BF16, BF16)
    return dts, sizes, [i % 5 == 1 for i in range(70)]


def _operands(name):
    """Fake addresses: each operand at its own 256-byte-aligned slot, ``b``
    one element further where the case says so."""
    dts, sizes, off = _case(name)
    ops, at = [], 1 << 20
    for (da, db), n, o in zip(dts, sizes, off):
        a, b, out = at, at + (1 << 30) + o * db.itemsize, at + (2 << 30)
        ops.append(Operands(da, db, n, a, b, out))
        at += 256 * (-(-n * 4 // 256) + 1)
    return ops


CASES = ("one", "mamba2-130m", "mixed-70")


@pytest.mark.parametrize("kb, threads", [(4, 256), (8, 128), (16, 1024)])
@pytest.mark.parametrize("name", CASES)
def test_plan_lays_out_the_tables_the_kernel_reads(name, kb, threads):
    pairs = _operands(name)
    launches = plan(pairs, kb, threads)
    per_block = kb * threads
    seen = []
    groups = {}
    for launch in launches:
        assert 1 <= len(launch.entries) <= TABLE_MAX
        groups.setdefault(launch.dtypes, []).append(launch)
        sizes = [pairs[e.pair].n for e in launch.entries]
        assert sizes == sorted(sizes, reverse=True)
        first = 0
        for e in launch.entries:
            p = pairs[e.pair]
            assert (p.a_dtype, p.b_dtype) == launch.dtypes and p.n > 0
            assert e.first == first
            first += math.ceil(p.n / per_block)
            # csrc/common.cuh chunk_bytes: up to 16 bytes a vector
            align_a = min(kb * p.a_dtype.itemsize, 16)
            align_b = min(kb * p.b_dtype.itemsize, 16)
            assert e.vector == (p.a % align_a == 0 and p.b % align_b == 0
                                and p.out % align_a == 0)
        assert launch.blocks == first
        seen += [e.pair for e in launch.entries]
    # every non-empty pair once; a dtype pair's chunks in order, each
    # table's smallest at least the next table's largest
    assert sorted(seen) == [i for i, p in enumerate(pairs) if p.n]
    for key, chunks in groups.items():
        count = sum(1 for p in pairs if p.n and (p.a_dtype, p.b_dtype) == key)
        assert len(chunks) == -(-count // TABLE_MAX)
        for x, y in zip(chunks, chunks[1:]):
            assert len(x.entries) == TABLE_MAX
            assert pairs[x.entries[-1].pair].n >= pairs[y.entries[0].pair].n
        # ties keep the call's order
        order = [e.pair for c in chunks for e in c.entries]
        assert order == sorted(order, key=lambda i: (-pairs[i].n, i))
    expected = {"one": 1, "mamba2-130m": 1, "mixed-70": 4}[name]
    assert len(launches) == expected
    if name == "mixed-70":  # vector moves refused where b is off
        flags = {e.pair: e.vector for la in launches for e in la.entries}
        assert not any(flags[i] for i in flags if i % 5 == 1)
        assert all(flags[i] for i in flags if i % 5 != 1)


@pytest.mark.parametrize("name", CASES)
def test_each_block_finds_its_pair_and_covers_it_once(name):
    """The kernel's block-to-pair search (csrc/pair_fuse.cu: the last entry
    whose first block is at or before the block), run over every block of
    each table: each pair's elements are covered once, in order."""
    kb, threads = build.DEFAULT_SHAPES["pair_fuse"]
    per_block = kb * threads
    pairs = _operands(name)
    for launch in plan(pairs, kb, threads):
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
            assert start == covered[e.pair] < pairs[e.pair].n
            covered[e.pair] = min(start + per_block, pairs[e.pair].n)
        assert all(covered[i] == pairs[i].n for i in covered)


@pytest.mark.parametrize("name", CASES)
def test_pair_fuse_many_equals_pair_fuse_ref_pair_by_pair(name):
    dts, sizes, off = _case(name)
    rng = np.random.default_rng(len(sizes))
    a_list, b_list = [], []
    for (da, db), n, o in zip(dts, sizes, off):
        a_list.append(torch.from_numpy(
            rng.standard_normal(n, dtype=np.float32)).to(da))
        b = torch.from_numpy(rng.standard_normal(n + 1, dtype=np.float32))
        b_list.append(b.to(db)[1:] if o else b[:n].to(db))  # a view off 0
    p0 = (pair_fuse.launches, pair_fuse.pairs)
    got = pair_fuse_many(a_list, b_list, op="wsum", wa=1.0, wb=0.37)
    assert (pair_fuse.launches, pair_fuse.pairs) == p0  # the CPU launches none
    for a, b, g in zip(a_list, b_list, got, strict=True):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert torch.equal(g, pair_fuse_ref(a, b, "wsum", 1.0, 0.37))

