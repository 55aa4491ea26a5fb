#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order (any failure ends the run
with a non-zero exit; no phase catches its own error):

 1. the card's name and power limit (nvidia-smi);
 2. build the hand-written CUDA kernels from src/repro_torch/kernels/csrc;
 3. hold each kernel against its plain PyTorch version on the card, at the
    main path's shapes, a ragged one, and for fused_agg and quant_agg one
    whose K x N exceeds 2**31 (the cost table's rows do), at the default
    launch shape and, bit for bit the same, at every other legal one; time
    both, the kernel's bound and one PyTorch call computing the same
    function; and the party-side int8 ``quantize`` on the card against the
    CPU's, bit for bit. pair_fuse's table launch is held bit for bit
    against the plain version pair by pair over mamba2-130m's and
    qwen3-0.6b's leaves, a misaligned view and 70 pairs, and each of those
    models' fold must be one launch; the single pair's time is printed
    beside the time one launch a pair gave, and each fold's beside the
    same fold made one launch a leaf (``table_phase`` runs this alone);
 4. the main path: ``Platform().train`` of qwen3-0.6b at full width (bf16),
    3 parties, 2 FedAvg rounds; the streaming fold must go through the
    pair_fuse kernel. One real fold of a party's update (all 14 leaves,
    synchronised) is timed beside the t_pair probe, which must predict it
    within 25 %. Then the same path at a small size on the card and on the
    CPU from the same weights (``conditioned``), which must agree;
 5. the batch path: ``FedAvg().fuse`` of the last round's real updates
    through the fused_agg kernel equals the streaming fold;
 6. the quantised path: the same updates quantised to int8 on the card and
    fused through the quant_agg kernel (one launch per leaf) stay within
    the int8 error bound of their exact fusion; then the serve_quantized
    example at full width;
 7. the fused global model saved as a checkpoint and loaded back onto the
    card, bit for bit;
 8. the simulation vehicles priced on the card: a kernel cost table
    searched and measured through the three kernels (every legal launch
    shape timed, the fastest kept) at the synthetic fleets' model
    sizes and qwen3-0.6b's (each row no faster than 0.95 x its roofline
    and, by device time, no slower than 1.25 x,
    the full-size pair_fuse row within 25 % of phase 4's t_pair probe
    scaled to the row's bytes, written to chiprun_out/), then the main
    path's measured arrivals
    replayed as a 16-job fleet and a synthetic 16-job fleet under JIT and
    eager-AO (JIT must bill fewer container-seconds), and an online
    service with SLA classes and an autoscaled pool run to drain, all
    priced by that table;
 9. the other families at full width (bf16), each freed before the next:
    ``Platform().train`` of qwen1.5-4b (q/k/v bias, 3 of 40 layers),
    qwen2.5-14b (GQA + bias, 3 of 48 layers) and qwen2-moe-a2.7b (60
    experts top-4 + 4 shared, 3 of 24 layers), 3 parties, 2 FedAvg rounds,
    every fold through pair_fuse, the eval loss finite and lower than the
    initial model's (a smoke signal only), one real fold timed beside the
    probe; for the MoE config also the batch path through fused_agg on its
    real updates and a training step bit-equal when repeated; then phase
    4's small card-vs-CPU agreement for the bias and the MoE families;
10. the examples on the card: ``federated_100m`` at full width and depth
    (example-100m, 4 parties, 10 FedProx rounds of 192 sequences), which
    must diverge where the JAX package's example does, ``quickstart``'s
    training half and ``multijob_scheduler``;
11. the launchers on the card, each model freed before the next: prefill
    and 128 greedy decode steps through ``launch.serve`` for qwen3-0.6b,
    qwen2.5-14b and qwen2-moe-a2.7b at full width and full depth (bf16), and
    llama4-scout-17b-a16e at full width and 4 of its 48 layers,
    each token in the vocabulary, each logit finite, the cache's ``t`` at
    prompt + tokens, peak memory under 80 GB, and a teacher-forced forward
    over the same tokens beside it; qwen3-0.6b's decode against its full
    forward in fp32 at full depth (rtol / atol 2e-2); ``launch.train.main``
    training qwen3-0.6b at full depth with AdamW, its loss falling over 5
    steps; then the card against the CPU at reduced sizes from the same
    ``conditioned`` weights (prefill and 8 decode steps of the four
    configs, 3 train steps of qwen3-0.6b);
12. the SSM, RG-LRU hybrid, audio and VLM families, each model freed
    before the next: ``Platform().train`` of mamba2-130m (24 of 24
    layers, from ``conditioned`` weights), recurrentgemma-9b (3 of 38) and
    musicgen-large (6 of 48) at full width as in phase 9 (the VLM's parties have no image
    inputs: the runtime refuses it, as the reference fails);
    ``launch.serve`` of mamba2-130m (B 8), recurrentgemma-9b (B 4) and
    musicgen-large (B 4) at full depth and of llama-3.2-vision-90b at 5 of
    100 layers (B 4, zero image embeddings of 1,601 tokens), prompt 1024
    and 128 greedy steps, checked as in phase 11; fp32 decode against the
    full forward at full depth for mamba2-130m and recurrentgemma-9b; the
    card against the CPU on the four reduced configs;
    ``scripts/torch_smoke_models.py`` over every architecture on the card;
13. the card's name and power limit again; each launcher run of phases 11
    and 12 (the train step; prefill and decode of each served config) and
    phase 4's local step beside ``analytic_roofline``'s compute and memory
    terms on one H100, from the times those phases took; qwen3-0.6b's
    B 8 x 128 train step counted on the card by ``FlopCounterMode``, which
    must equal its count on meta tensors (``launch.dryrun``); the launch-
    shape search at the cost table's sizes and qwen3-0.6b's leaf sizes
    (default, best and bound of each; the host launch cost and the fitted
    per-block cost; rows to chiprun_out/launch_shape_search.json); phase
    3's times within 1.25 x their bound (the cost table's rows are held to
    it in phase 8, by device time);
14. the benchmarks on the card (``repro_torch.benchmarks``): kernel_bench's
    model and measured rows, checked against its H100 baseline (launch
    shapes exactly, every measured shape within 1.25 x its bound in device
    time); real_ablation on qwen3-0.6b at full width and depth (3 parties,
    2 FedProx rounds of 48 sequences, every strategy replayed; JIT must
    bill no more container-seconds than eager-AO); periodicity (Figs. 3-4);
15. the sharding half on a one-rank NCCL group and its 1 x 1 mesh
    (``launch.mesh.one_rank_mesh``): the expert-parallel MoE branch
    (``models.moe._moe_apply_shard_map``) at full width against
    ``moe_apply`` for qwen2-moe-a2.7b (60 experts) and llama4-scout-17b-
    a16e (16 experts, sequence-parallel: its gather and reduce-scatter span
    the one rank), x (4, 512, d_model) in bf16; ``launch.train.main
    --profile optimized`` on reduced qwen2-moe-a2.7b for 3 steps through
    that branch, its losses against the baseline profile's; and
    ``benchmarks.dist_agg.measure`` of qwen3-0.6b (K = 8 fp32 updates of
    751,632,384 parameters, 24.05 GB) through the fused_agg kernel, held
    against its plain version, timed beside its bound (at most 1.25 x);
16. the production layout (``layout_phase``): ``run_on_mesh`` of
    qwen3-0.6b on a one-rank NCCL 1 x 1 mesh against ``run_one_device``,
    and the dry count of its 16 x 16 layout;
17. Nemotron-3-Nano's cut (bench/configs/nemotron-3-nano-30b-a3b.json:
    13 of 52 layers, 16 of 128 experts held, 16,384 of 131,072 vocabulary
    rows, every width published), from ``conditioned`` weights:
    ``Platform().train`` as in phase 9 (3 parties, 2 FedAvg rounds, the
    eval loss dropping and finite), then one batch (B 2 x S 1024) through
    the port's bf16 forward against the plain float32 reference
    (bench/fedbench/reference/nemotron_h.py), within ``NEMOTRON_TOL``,
    which the same forward in fp8 weights, without the shared expert or
    without the correction bias must exceed; the MoE routing counters
    (``moe.dropped`` 0, held over all assignments printed);
18. one JSON line with every kernel's numbers, then the result line.

It imports nothing of JAX or of the JAX package, and needs one card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

MAIN_N = 151_936 * 1024  # qwen3-0.6b's largest leaf (embed, lm_head)
RAGGED_N = 1_000_003
BIG_K, BIG_N = 8, 300_000_000  # K x N = 2.4e9 > 2**31 elements
# the synthetic fleets' model sizes (JOB_MIX) and qwen3-0.6b's bf16 model
TABLE_SIZES = (52_428_800, 209_715_200, 524_288_000, 1_503_264_768)
SEED = 0
# phase 9: (config, layers kept) at full width. Without qk_norm, the
# reference's init makes the gradient grow about tenfold a layer, and plain
# SGD blows the residual stream up past a few layers
# (scripts/torch_lr_sweep.py); 3 layers train at the main path's lr in all
# three. PERF.md gives the memory reckoning.
FAMILIES = (("qwen1.5-4b", 3), ("qwen2.5-14b", 3), ("qwen2-moe-a2.7b", 3))
# phase 11: (config, batch) served at full width and depth, with the prompt
# length and the greedy decode steps; PERF.md gives the memory reckoning
SERVES = (("qwen3-0.6b", 8), ("qwen2.5-14b", 4), ("qwen2-moe-a2.7b", 4))
PROMPT, TOKENS = 1024, 128
# phase 12: (config, layers kept, from conditioned weights) trained at full
# width as in phase 9, and (config, layers kept, batch) served at full
# width; PERF.md gives the memory reckoning. musicgen-large still learns at
# 6 layers, not at 12 (scripts/torch_lr_sweep.py). From the seeded weights
# mamba2-130m's gradient turns NaN within two rounds: the reference's SSD
# pass overflows exp() in the masked triangle of a chunk (ROADMAP Queue 3),
# which the port copies; ``conditioned`` draws its dt_bias as Mamba-2 does
RECURRENT_TRAIN = (("mamba2-130m", 24, True), ("recurrentgemma-9b", 3, False),
                   ("musicgen-large", 6, False))
RECURRENT_SERVES = (("mamba2-130m", 24, 8), ("recurrentgemma-9b", 38, 4),
                    ("musicgen-large", 48, 4), ("llama-3.2-vision-90b", 5, 4))
# phase 11: (config, layers kept, batch) served at full width and cut depth.
# llama4-scout-17b-a16e holds 4.271e9 parameters at 1 layer (2.07e9 of them
# the embedding and the unembedding) and 1.088e10 at 4, 21.75 GB in bf16;
# every layer is a MoE block, so the cut keeps every kind of layer. PERF.md
# gives the memory reckoning
CUT_SERVES = (("llama4-scout-17b-a16e", 4, 4),)
CARD_BYTES = 80e9
# phase 3: the models whose fold one pair_fuse launch makes over a table of
# every leaf, checked and timed as such, and the times one launch a pair
# gave before the table (PERF.md's kernel table and section 6): pair_fuse at
# MAIN_N, and mamba2-130m's 17-leaf fold in the benchmark's trace
TABLE_MODELS = ("mamba2-130m", "qwen3-0.6b")
PAIR_A_LAUNCH_MS = {"single": 0.5167, "mamba2-130m fold": 0.574}
# phase 15: (config, tolerance of the expert-parallel branch against
# moe_apply, relative to the output's largest magnitude). On one rank the
# branch computes moe_apply's sums in the same order, so it should be
# equal; one bf16 rounding, 2**-8, is the most it may differ.
MOE_BRANCH = (("qwen2-moe-a2.7b", 2.0 ** -8), ("llama4-scout-17b-a16e",
                                               2.0 ** -8))
MOE_X = (4, 512)  # (B, S) of the branch's input

# a kernel's device time over its bound, at most: phase 3's times and the
# cost table's rows (PERF.md section 2)
KERNEL_LIMIT = 1.25

# phase 17: Nemotron-3-Nano's cut, its configuration file (the published
# keys and the cut's ``run`` block), the batch of its agreement and the
# agreement's tolerance: the port's bf16 logits against the float32
# reference's, ||port - reference|| / ||reference|| over the batch. The
# bf16 forward's own rounding, carried through 13 layers and flipping a
# few of the 61,440 top-6 choices, reads 0.087 on one H100; its weights
# rounded to fp8 e4m3 (3 mantissa bits against bf16's 7) read 0.27, and
# leaving out the shared expert or the correction bias 1.24 and 0.62
# (PERF.md section 6), so 0.15 passes the first and refuses the
# other three with room on both sides
NEMOTRON = "nemotron-3-nano-30b-a3b"
NEMOTRON_FILE = Path(__file__).resolve().parent / "bench" / "configs" / (
    NEMOTRON + ".json")
NEMOTRON_BATCH = (2, 1024)
NEMOTRON_TOL = 0.15


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds of ``fn`` on the card: the median over 3 runs of the
    mean of ``iters`` calls between CUDA events. One run of 20 right
    after the caching allocator has handed gigabytes back to the driver
    can read 16 % slow (pair_fuse 0.596 ms, then 0.514; ``PERF.md`` §6),
    so a single run is not kept."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The H100's least time for the bytes and the fp32 operations (outside
    the tensor cores: the kernels' multiply-adds never reach them)."""
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import bandwidth_time_s

    t_bytes = bandwidth_time_s(n_bytes, H100) * 1e3
    t_ops = n_flops / H100.peak_flops_fp32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def other_shapes(kernel: str, k: int, n: int, update_itemsize: int):
    """The legal launch shapes (bn, kb) of ``kernel`` over n elements but
    the default, which the kernel's results at each are held against."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.build import default_tile

    return [c for c in autotune.candidates(kernel, k, n, update_itemsize)
            if c != default_tile(kernel)]


def same_at_every_shape(name: str, got, launch, shapes) -> int:
    """``launch(bn, kb)`` at each of ``shapes`` equals ``got`` (the default
    shape's result) bit for bit: each element's arithmetic is the same at
    every shape. Returns the shapes checked, the default included."""
    import torch

    for bn, kb in shapes:
        if not torch.equal(launch(bn, kb), got):
            raise AssertionError(f"{name} at bn={bn} kb={kb} differs from "
                                 f"the default shape")
    return len(shapes) + 1


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------
def check_pair_fuse(torch, gen):
    """All four ops, fp32+fp32 / bf16+bf16 / fp32 acc + bf16 update, at the
    main-path N and a ragged N. Tolerance: mean/max/min exact; wsum rounds
    each product and the sum in fp32 like the plain version, so it is held
    to one fp32 rounding of its terms, 2**-23 * (|wa*a| + |wb*b|), and a bf16
    output to one bf16 ulp of the same scale, 2**-7 * (...)."""
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.ref import pair_fuse_ref

    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    for n in (MAIN_N, RAGGED_N):
        for ta, tb in ((f32, f32), (bf16, bf16), (f32, bf16)):
            a = torch.randn(n, generator=gen, device="cuda").to(ta)
            b = torch.randn(n, generator=gen, device="cuda").to(tb)
            for op, wa, wb in (("mean", 0.5, 0.5), ("wsum", 0.3, 0.7),
                               ("max", 1.0, 1.0), ("min", 1.0, 1.0)):
                got = pair_fuse(a, b, op=op, wa=wa, wb=wb)
                want = pair_fuse_ref(a, b, op, wa, wb)
                if got.dtype != ta or got.shape != (n,):
                    raise AssertionError(f"pair_fuse {op}: {got.dtype} "
                                         f"{tuple(got.shape)}")
                err = (got.float() - want.float()).abs()
                if op in ("max", "min"):
                    ok = bool((err == 0).all())
                else:
                    ulp = 2.0 ** -23 if ta == f32 else 2.0 ** -7
                    scale = wa * a.float().abs() + wb * b.float().abs()
                    ok = bool((err <= ulp * scale).all())
                e = float(err.max())
                if not ok:
                    raise AssertionError(f"pair_fuse {op} disagrees: {e}")
                shapes = same_at_every_shape(
                    f"pair_fuse {op}", got,
                    lambda bn, kb: pair_fuse(a, b, op=op, wa=wa, wb=wb,
                                             bn=bn, kb=kb),
                    other_shapes("pair_fuse", 2, n, tb.itemsize))
                log(f"  pair_fuse {op:4s} {str(ta)[6:]}+{str(tb)[6:]} "
                    f"N={n}: max_abs_err={e:.3e}, the same bits at all "
                    f"{shapes} legal launch shapes ok")
                worst = max(worst, e)
                del got, want, err
            del a, b
    # the fold's entry point: many pairs of leaves (any rank, an empty one,
    # the three dtype pairs) from one call, each the bits of its own launch
    from repro_torch.kernels.pair_fuse import pair_fuse_many

    shapes = ((RAGGED_N,), (3, 1001), (0,), (768, 33), (7,), (4, 5, 6))
    pairs = ((f32, f32), (bf16, bf16), (f32, bf16))
    a_list = [torch.randn(s, generator=gen, device="cuda").to(pairs[i % 3][0])
              for i, s in enumerate(shapes)]
    b_list = [torch.randn(s, generator=gen, device="cuda").to(pairs[i % 3][1])
              for i, s in enumerate(shapes)]
    outs = pair_fuse_many(a_list, b_list, op="wsum", wa=1.0, wb=0.3)
    for a, b, got in zip(a_list, b_list, outs, strict=True):
        one = pair_fuse(a.reshape(-1), b.reshape(-1), op="wsum", wa=1.0,
                        wb=0.3).reshape(a.shape)
        if got.shape != a.shape or got.dtype != a.dtype or not torch.equal(
                got, one):
            raise AssertionError(f"pair_fuse_many disagrees with pair_fuse "
                                 f"at {tuple(a.shape)} {a.dtype}+{b.dtype}")
    log(f"  pair_fuse_many over {len(shapes)} leaves of shapes {shapes}: "
        f"each leaf the bits of its own pair_fuse launch ok")
    torch.cuda.synchronize()
    return worst


def check_pair_fuse_table(torch, gen):
    """The table launch (``pair_fuse_many``) against ``pair_fuse_ref``
    pair by pair, bit for bit, all four ops at every legal launch shape,
    over TABLE_MODELS' leaves (fp32 accumulator + bf16 update), those of
    mamba2-130m with every ``b`` a view one element off its vector's
    alignment, and 70 pairs of the three dtype pairs (two tables of fp32 +
    bf16, an empty pair among them); each call makes the launches ``plan``
    lays out. Then ``accumulate`` of each model's update: one launch a fold
    (``pair_fuse.launches``, ``pair_fuse.pairs``). Returns the leaf sizes of
    TABLE_MODELS."""
    from repro_torch import configs, tree_leaves
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.ops import accumulate
    from repro_torch.kernels.pair_fuse import (Operands, pair_fuse,
                                               pair_fuse_many, plan)
    from repro_torch.kernels.ref import pair_fuse_ref
    from repro_torch.models import model as M

    f32, bf16 = torch.float32, torch.bfloat16
    configs.load_all()
    shapes = {name: [tuple(s.shape) for s in tree_leaves(
        M.param_specs(configs.get_config(name)))] for name in TABLE_MODELS}
    rng = torch.Generator().manual_seed(SEED)
    sizes70 = torch.randint(1, 300_000, (70,), generator=rng).tolist()
    sizes70[30] = 0
    dts70 = [(f32, bf16)] * 70
    dts70[10], dts70[20] = (f32, f32), (bf16, bf16)
    cases = [(name, [(f32, bf16, s, False) for s in shapes[name]])
             for name in TABLE_MODELS]
    cases.append(("mamba2-130m misaligned",
                  [(f32, bf16, s, True) for s in shapes["mamba2-130m"]]))
    cases.append(("70 pairs", [(da, db, (n,), i % 5 == 1) for i, ((da, db), n)
                               in enumerate(zip(dts70, sizes70))]))
    kb, threads = build.DEFAULT_SHAPES["pair_fuse"]
    every = [(None, None)] + [c for c in autotune.candidates(
        "pair_fuse", 2, MAIN_N, 2) if c != build.default_tile("pair_fuse")]
    for name, spec in cases:
        a_list, b_list = [], []
        for da, db, shape, off in spec:
            n = math.prod(shape)
            a_list.append(torch.randn(n, generator=gen, device="cuda")
                          .to(da).view(shape))
            b = torch.randn(n + off, generator=gen, device="cuda").to(db)
            b_list.append(b[off:].view(shape))
        launches = len(plan([Operands(a.dtype, b.dtype, a.numel(),
                                      a.data_ptr(), b.data_ptr(), 0)
                             for a, b in zip(a_list, b_list)], kb, threads))
        for op, wa, wb in (("wsum", 1.0, 0.37), ("mean", 0.5, 0.5),
                           ("max", 1.0, 1.0), ("min", 1.0, 1.0)):
            want = [pair_fuse_ref(a.reshape(-1), b.reshape(-1), op, wa, wb)
                    .reshape(a.shape) for a, b in zip(a_list, b_list)]
            for bn, kbs in every:
                l0 = pair_fuse.launches
                got = pair_fuse_many(a_list, b_list, op=op, wa=wa, wb=wb,
                                     bn=bn, kb=kbs)
                if pair_fuse.launches - l0 != launches:
                    raise AssertionError(
                        f"pair_fuse_many {name}: {pair_fuse.launches - l0} "
                        f"launches, {launches} planned")
                for a, w, g in zip(a_list, want, got, strict=True):
                    if g.dtype != a.dtype or not torch.equal(g, w):
                        raise AssertionError(
                            f"pair_fuse_many {name} {op} at bn={bn} kb={kbs}"
                            f": a leaf of {tuple(a.shape)} {a.dtype} differs "
                            f"from pair_fuse_ref")
                del got
            del want
        log(f"  pair_fuse table, {name}: {len(spec)} pairs in {launches} "
            f"launch(es), each pair the bits of pair_fuse_ref, 4 ops at all "
            f"{len(every)} legal launch shapes ok")
        del a_list, b_list
        torch.cuda.empty_cache()
    for name in TABLE_MODELS:
        acc = [torch.randn(math.prod(s), generator=gen, device="cuda")
               .view(s) for s in shapes[name]]
        upd = [torch.randn(math.prod(s), generator=gen, device="cuda")
               .to(bf16).view(s) for s in shapes[name]]
        l0, p0 = pair_fuse.launches, pair_fuse.pairs
        accumulate(acc, upd, 0.37)
        got = (pair_fuse.launches - l0, pair_fuse.pairs - p0)
        log(f"  accumulate, {name}: {got[0]} pair_fuse launch(es), "
            f"{got[1]} pairs ({len(acc)} leaves)")
        if got != (1, len(acc)):
            raise AssertionError(f"{name}'s fold is not one launch of "
                                 f"every leaf: {got}")
        del acc, upd
    torch.cuda.synchronize()
    return {name: [math.prod(s) for s in shapes[name]]
            for name in TABLE_MODELS}


def time_table_folds(torch, gen, sizes) -> dict:
    """Device time (CUDA events, ``cuda_ms``) of one fold of each model of
    ``sizes`` (leaf sizes; fp32 accumulator + bf16 update, wsum): the
    table launch (``accumulate``) against the same fold made one pair_fuse
    launch a leaf, largest first, as the fold ran before the table, and
    the latter's time in the benchmark's trace."""
    from repro_torch.kernels.ops import accumulate
    from repro_torch.kernels.pair_fuse import pair_fuse

    out = {}
    for name, leaves in sizes.items():
        acc = [torch.randn(n, generator=gen, device="cuda")
               for n in sorted(leaves, reverse=True)]
        upd = [torch.randn(n, generator=gen, device="cuda").to(
            torch.bfloat16) for n in sorted(leaves, reverse=True)]
        table = cuda_ms(lambda: accumulate(acc, upd, 0.37))
        per_leaf = cuda_ms(lambda: [pair_fuse(a, u, op="wsum", wa=1.0,
                                              wb=0.37)
                                    for a, u in zip(acc, upd)])
        n = sum(leaves)
        bound, _ = bound_ms(n * (4 + 2 + 4), 3 * n)
        out[name] = {"leaves": len(leaves), "table_ms": table,
                     "per_leaf_ms": per_leaf, "bound_ms": bound}
        log(f"  one fold of {name} ({len(leaves)} leaves, {n:,} elements): "
            f"table launch {table:.4f} ms, one launch a leaf {per_leaf:.4f} "
            f"ms ({per_leaf / table:.4f} x), bound {bound:.4f} ms "
            f"({100 * bound / table:.2f} % of it)")
        del acc, upd
    before = PAIR_A_LAUNCH_MS["mamba2-130m fold"]
    if "mamba2-130m" in out:
        log(f"  mamba2-130m's fold one launch a leaf in the benchmark's "
            f"trace before the table: {before} ms (device time of its "
            f"kernels alone); the table launch {out['mamba2-130m']['table_ms']:.4f} "
            f"ms with its gaps")
    torch.cuda.synchronize()
    return out


def table_phase(torch) -> dict:
    """Phase 3's table checks and times on their own, after the card's line
    and the build: ``PYTHONPATH=src python3 -c "import sys, torch;
    sys.path.insert(0, '.'); import chip_smoke; chip_smoke.table_phase(torch)"``.
    Prints and returns the single pair's time at MAIN_N beside its bound
    and the time one launch a pair gave, and each model's fold."""
    from repro_torch.kernels import build

    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    log(f"built in {build.build_all():.2f} s")
    for text in build.build_log.values():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"  {len(regs)} instantiations, {min(regs)}-{max(regs)} "
            f"registers/thread, {spills} bytes of spills")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t_pf, _ = time_kernels(torch, gen)
    single = single_pair_line(t_pf)
    folds = time_table_folds(torch, gen, check_pair_fuse_table(torch, gen))
    res = {"single": single, "folds": folds}
    log("  table phase summary: " + json.dumps(res))
    return res


def single_pair_line(t: dict) -> dict:
    """pair_fuse at MAIN_N (a table of one) beside its bound and the time
    one launch a pair gave."""
    before = PAIR_A_LAUNCH_MS["single"]
    log(f"  pair_fuse at N={MAIN_N:,}, a table of one: {t['ms']:.4f} ms "
        f"(bound {t['bound_ms']:.4f} ms, {t['ms'] / t['bound_ms']:.4f} x); "
        f"one launch a pair gave {before} ms: "
        f"{'no slower' if t['ms'] <= before else 'slower'}")
    return {"ms": t["ms"], "bound_ms": t["bound_ms"], "before_ms": before}


def check_fused_agg(torch, gen):
    """K = 3 and K = 17 (above the TPU kernel's 8-row tile), fp32 and bf16,
    main-path and ragged N; and K = 8 fp32 at N = 300,000,000, where row
    offsets pass 2**31 elements as in the cost table's rows. Tolerance: the kernel and the plain version
    (a cuBLAS product in full fp32) sum K terms in other orders, so they
    may differ by K fp32 roundings of sum_k |w_k u_kn|, and a bf16 output by
    one more bf16 ulp, 2**-7, of the same scale."""
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.ref import fused_agg_ref

    cases = [(k, n, dt) for n in (MAIN_N, RAGGED_N) for k in (3, 17)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((BIG_K, BIG_N, torch.float32))
    worst = 0.0
    for k, n, dt in cases:
        u = torch.randn(k, n, generator=gen, device="cuda").to(dt)
        w = torch.rand(k, generator=gen, device="cuda")
        w = w / w.sum()
        got = fused_agg(u, w)
        want = fused_agg_ref(u, w)
        if got.dtype != dt or got.shape != (n,):
            raise AssertionError(f"fused_agg: {got.dtype} "
                                 f"{tuple(got.shape)}")
        scale = torch.einsum("k,kn->n", w, u.float().abs())
        tol = k * 2.0 ** -23 + (2.0 ** -7 if dt == torch.bfloat16 else 0.0)
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol * scale).all())
        e = float(err.max())
        if not ok:
            raise AssertionError(f"fused_agg disagrees: {e}")
        del want, scale, err
        shapes = same_at_every_shape(
            "fused_agg", got, lambda bn, kb: fused_agg(u, w, bn=bn, kb=kb),
            other_shapes("fused_agg", k, n, dt.itemsize))
        log(f"  fused_agg K={k:2d} {str(dt)[6:]} N={n}: "
            f"max_abs_err={e:.3e}, the same bits at all {shapes} legal "
            f"launch shapes ok")
        worst = max(worst, e)
        del u, got
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def time_kernels(torch, gen):
    """Time each kernel at its main-path shape: pair_fuse folds a bf16
    update into the fp32 accumulator (wsum), fused_agg fuses 3 bf16
    updates of the largest leaf."""
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.ref import fused_agg_ref, pair_fuse_ref

    n, w = MAIN_N, 0.37
    acc = torch.randn(n, generator=gen, device="cuda")
    upd = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    pf = {
        "ms": cuda_ms(lambda: pair_fuse(acc, upd, op="wsum", wa=1.0, wb=w)),
        "plain_ms": cuda_ms(lambda: pair_fuse_ref(acc, upd, "wsum", 1.0, w)),
        "library_ms": cuda_ms(lambda: torch.add(acc, upd, alpha=w)),
    }
    pf["bound_ms"], pf["bound_by"] = bound_ms(n * (4 + 2 + 4), 3 * n)
    del acc, upd
    k = 3
    u = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
    wk = torch.full((k,), 1.0 / k, device="cuda")
    wk16 = wk.to(torch.bfloat16)
    fa = {
        "ms": cuda_ms(lambda: fused_agg(u, wk)),
        "plain_ms": cuda_ms(lambda: fused_agg_ref(u, wk)),
        "library_ms": cuda_ms(lambda: torch.matmul(wk16, u)),
    }
    fa["bound_ms"], fa["bound_by"] = bound_ms(k * n * 2 + n * 2 + k * 4,
                                              2 * k * n)
    del u
    torch.cuda.synchronize()
    return pf, fa


def check_quant_agg(torch, gen):
    """K = 1, 3, 4, 17 and 40 (above the TPU kernel's 32-row slab) at the
    main-path N and a ragged N, K = 3 at the main-path N from a base one
    byte past an aligned one (the scalar instance runs for a ragged row
    length and for a misaligned base), and K = 8 at N = 300,000,000, where
    row offsets pass 2**31 elements as in the cost table's rows. int8 in [-127, 127], positive fp32
    scales. Tolerance: the kernel and the plain version (a cuBLAS product in
    full fp32) sum K terms in other orders, so they may differ by K fp32
    roundings of sum_k |s_k q_kn|."""
    from repro_torch.kernels.quant_agg import quant_agg
    from repro_torch.kernels.ref import quant_agg_ref

    cases = [(k, n, 0) for n in (MAIN_N, RAGGED_N) for k in (1, 3, 4, 17, 40)]
    cases += [(3, MAIN_N, 1), (BIG_K, BIG_N, 0)]
    worst = 0.0
    for k, n, offset in cases:
        buf = torch.randint(-127, 128, (k * n + offset,), generator=gen,
                            device="cuda", dtype=torch.int8)
        q = buf[offset:].view(k, n)
        s = torch.rand(k, generator=gen, device="cuda") + 1e-3
        got = quant_agg(q, s)
        want = quant_agg_ref(q, s)
        if got.dtype != torch.float32 or got.shape != (n,):
            raise AssertionError(f"quant_agg: {got.dtype} {tuple(got.shape)}")
        err = (got - want).abs()
        del want
        scale = quant_agg_ref(q.abs(), s)
        ok = bool((err <= k * 2.0 ** -23 * scale).all())
        e = float(err.max())
        if not ok:
            raise AssertionError(f"quant_agg disagrees: {e}")
        del err, scale
        shapes = same_at_every_shape(
            "quant_agg", got, lambda bn, kb: quant_agg(q, s, bn=bn, kb=kb),
            other_shapes("quant_agg", k, n, 1))
        log(f"  quant_agg K={k:2d} N={n}{' base+1' if offset else ''}: "
            f"max_abs_err={e:.3e}, the same bits at all {shapes} legal "
            f"launch shapes ok")
        worst = max(worst, e)
        del buf, q, got
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def check_quantize(torch, gen):
    """The party-side quantize on the card equals the CPU's bit for bit
    (q and scale), for one fp32 and one bf16 leaf at the main-path N."""
    from repro_torch.kernels.quant_agg import quantize

    for dt in (torch.float32, torch.bfloat16):
        x = (0.02 * torch.randn(MAIN_N, generator=gen, device="cuda")).to(dt)
        q, s = quantize(x)
        qc, sc = quantize(x.cpu())
        bad = int((q.cpu() != qc).sum())
        same_s = s.cpu().view(torch.int32).item() == sc.view(torch.int32).item()
        log(f"  quantize {str(dt)[6:]} N={MAIN_N}: card vs CPU {bad} q "
            f"mismatches, scale {float(s):.9e} vs {float(sc):.9e} "
            f"{'ok' if bad == 0 and same_s else 'FAIL'}")
        if bad or not same_s:
            raise AssertionError("quantize on the card differs from the CPU")
        del x, q, qc


def time_quant_agg(torch, gen):
    """Time quant_agg at K = 3 int8 rows of the largest leaf. No single
    PyTorch call takes int8 rows with fp32 scales, so it has no library
    time."""
    from repro_torch.kernels.quant_agg import quant_agg
    from repro_torch.kernels.ref import quant_agg_ref

    k, n = 3, MAIN_N
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(k, generator=gen, device="cuda") + 1e-3
    qa = {"ms": cuda_ms(lambda: quant_agg(q, s)),
          "plain_ms": cuda_ms(lambda: quant_agg_ref(q, s)),
          "library_ms": None}
    qa["bound_ms"], qa["bound_by"] = bound_ms(k * n + 4 * n + 4 * k, 2 * k * n)
    del q
    torch.cuda.synchronize()
    return qa


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------
def main_path(torch):
    from repro_torch import configs, tree_leaves
    from repro_torch.api import Platform
    from repro_torch.core.jobspec import FLJobSpec, PartySpec
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.models import model as M

    configs.load_all()
    cfg = configs.get_config("qwen3-0.6b")  # full width, bf16
    n_params = M.n_params(cfg)
    job = FLJobSpec(
        job_id="qwen3-0.6b-smoke", model_arch=cfg.name,
        model_bytes=n_params * 2, aggregation_algorithm="fedavg", rounds=2,
        lr=0.05, batch_size=8,
        parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)},
    )
    log(f"main path: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}: {n_params:,} "
        f"params, {job.n_parties} parties, {job.rounds} rounds")
    init = M.init(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    kw = dict(n_sequences=48, eval_sequences=16, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    pair_fuse.launches = fused_agg.launches = 0
    t0 = time.perf_counter()
    res = Platform().train(cfg, job, initial_params=init, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pair_fuse": pair_fuse.launches,
                "fused_agg": fused_agg.launches}

    rt = res.runtime
    with torch.no_grad():
        batch = {k: torch.from_numpy(v.astype("int64")).cuda()
                 for k, v in rt.eval_data.items() if k != "domains"}
        loss0 = float(M.loss_fn(cfg, init, batch)[0])
    for rec, measured in zip(res.records, rt.measured_rounds):
        log(f"  {rec}")
        log(f"  round {rec.round_idx} local training (host clock, s): "
            + ", ".join(f"{p}={t:.4f}" for p, (t, _) in measured.items()))
    log(f"  eval loss before={loss0:.6f} after={res.records[-1].global_loss:.6f}"
        f"; t_pair(probe, full size)={rt.t_pair0 * 1e3:.4f} ms; "
        f"Platform.train wall={wall:.3f} s (host clock, build and "
        f"calibration included); peak device memory="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches during the main path: {launches}")
    log(f"  metrics: {res.metrics}")
    if launches["pair_fuse"] <= 0:
        raise AssertionError("the main path never launched pair_fuse")
    check_trained(torch, cfg, res, loss0)
    fold_against_probe(torch, res)
    del init
    return res, launches


def check_trained(torch, cfg, res, loss0):
    """Every round's eval loss finite, the last below the initial model's
    ``loss0``, and the fused model finite with the config's shapes in
    bf16."""
    from repro_torch import tree_leaves
    from repro_torch.models import model as M

    for rec in res.records:
        if not (rec.global_loss == rec.global_loss and rec.global_loss < 1e9):
            raise AssertionError(f"round {rec.round_idx} loss not finite")
    if not res.records[-1].global_loss < loss0:
        raise AssertionError(f"eval loss did not drop: {loss0} -> "
                             f"{res.records[-1].global_loss}")
    specs = tree_leaves(M.param_specs(cfg))
    for s, p in zip(specs, tree_leaves(res.runtime.global_params),
                    strict=True):
        if tuple(p.shape) != s.shape or p.dtype != torch.bfloat16:
            raise AssertionError(f"fused leaf {tuple(p.shape)} {p.dtype}")
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("fused parameters not finite")


def fold_against_probe(torch, res, trials: int = 7) -> None:
    """One real fold, timed as the probe times itself: the fold that
    ``AggregationExecutor.drain`` applies to each message
    (``FusionState.fold``) of the last round's second update into the
    accumulator holding its first, every leaf, synchronised; the median of
    ``trials`` after 3 warmups, on the host clock. The probe
    (``probe_t_pair``) must predict it within 25 %. Beside it, for the
    record: the host's part of the fold (until the call returns, before the
    synchronisation), and the same fold made one ``pair_fuse`` call a leaf
    from Python, as ``accumulate`` made it before ``pair_fuse_many``."""
    from repro_torch import tree_leaves
    from repro_torch.fl.fusion import FusionState, get_algorithm
    from repro_torch.kernels.pair_fuse import pair_fuse

    rt = res.runtime
    _, updates, n_ex = last_round_updates(res)
    alg = get_algorithm(rt.spec.aggregation_algorithm)
    w1 = alg.weight_of(n_ex[1])
    st = FusionState().fold(updates[0], alg.weight_of(n_ex[0]))
    acc, upd = tree_leaves(st.acc), tree_leaves(updates[1])

    def leaf_by_leaf():
        return [pair_fuse(a.reshape(-1), u.reshape(-1), op="wsum", wa=1.0,
                          wb=float(w1)).reshape(a.shape)
                for a, u in zip(acc, upd)]

    def timed(fold) -> tuple:
        t0 = time.perf_counter()
        fold()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, t1 - t0

    def median_of(fold) -> tuple:
        for _ in range(3):  # warmup
            timed(fold)
        runs = [timed(fold) for _ in range(trials)]
        return tuple(statistics.median(r[i] for r in runs) for i in (0, 1))

    fold, host = median_of(lambda: st.fold(updates[1], w1))
    ratio = fold / rt.t_pair0
    log(f"  one real fold ({len(upd)} leaves, host clock, synchronised): "
        f"{fold * 1e3:.4f} ms (the host's part {host * 1e3:.4f} ms); t_pair "
        f"probe {rt.t_pair0 * 1e3:.4f} ms; fold / probe {ratio:.4f}")
    if abs(ratio - 1.0) > 0.25:
        raise AssertionError("the t_pair probe does not predict the fold")
    fold_1, host_1 = median_of(leaf_by_leaf)
    log(f"  the same fold one pair_fuse call a leaf: {fold_1 * 1e3:.4f} ms "
        f"(the host's part {host_1 * 1e3:.4f} ms)")


def conditioned(torch, tree, gen):
    """``tree`` with the attention projections rescaled to a fan-in over
    their input axes (d_model for wq, wk and wv; heads x head_dim for wo),
    the q/k/v biases and a sigmoid router's ``e_score_correction_bias``
    drawn from N(0, 0.1^2) and the SSM's ``dt_bias`` drawn
    as Mamba-2 initialises it (dt log-uniform in [1e-3, 0.1], the bias its
    inverse softplus), with ``gen`` (a CPU generator; each drawn leaf takes
    its leaf's device and dtype). The initialisation takes the fan-in from
    the heads axis, which without qk_norm peaks the attention so sharply
    that training is chaotic, and sets ``dt_bias`` to zeros, so that dt is
    about 0.7 a position and the decay summed over a chunk of 64 comes
    within a few units of exp's fp32 overflow at 88.7, past which the SSD
    gradient is NaN (ROADMAP Queue 3); these weights are neither."""
    import math

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = conditioned(torch, v, gen)
        elif k in ("wq", "wk", "wv"):  # (layers, d, heads, head_dim)
            out[k] = v * math.sqrt(v.shape[-2] / v.shape[-3])
        elif k == "wo":  # (layers, heads, head_dim, d)
            out[k] = v / math.sqrt(v.shape[-3])
        elif k in ("bq", "bk", "bv", "e_score_correction_bias"):
            out[k] = (0.1 * torch.randn(v.shape, generator=gen)).to(
                v.device, v.dtype)
        elif k == "dt_bias":  # (layers, heads)
            dt = torch.empty(v.shape).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen).exp()
            out[k] = (dt + torch.log(-torch.expm1(-dt))).to(v.device, v.dtype)
        else:
            out[k] = v
    return out


def small_agreement(torch, name: str = "qwen3-0.6b"):
    """The same path at a small size (2 layers, d_model 64, vocab 128, fp32)
    on the card and on the CPU from the same ``conditioned`` weights, 2
    FedAvg rounds at lr 0.05. Tolerance: rtol 1e-4, atol 1e-5 on eval
    losses and fused parameters (fp32 products summed in other orders over
    local SGD).

    The configs without qk_norm need the conditioning: from the seeded
    initialisation their job is chaotic, the CPU's own result moving by
    2.8e-5 to 3.6e-5 in one round and by 5.6e-3 to 7.9e-3 in two under a
    1e-7 change of its weights, and the card's by as much; from the
    conditioned weights it moves by 3.6e-7, while every leaf moves by 7e-4
    or more (``scripts/torch_small_agreement.py`` measures both)."""
    from repro_torch import configs, tree_leaves
    from repro_torch.api import Platform
    from repro_torch.core.jobspec import FLJobSpec, PartySpec
    from repro_torch.models import model as M

    cfg = configs.get_config(name).reduced(
        num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    init = conditioned(torch, M.init(cfg, torch.Generator().manual_seed(SEED)),
                       torch.Generator().manual_seed(SEED))
    out = {}
    for dev in ("cuda", "cpu"):
        job = FLJobSpec(
            job_id="small", model_arch=cfg.name,
            model_bytes=M.n_params(cfg) * 4, rounds=2, lr=0.05,
            batch_size=8,
            parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)})
        res = Platform().train(cfg, job, device=dev, initial_params=init,
                               n_sequences=48, eval_sequences=16, seed=SEED)
        out[dev] = res
    for rc, rp in zip(out["cuda"].records, out["cpu"].records, strict=True):
        if abs(rc.global_loss - rp.global_loss) > 1e-5 + 1e-4 * abs(rp.global_loss):
            raise AssertionError(f"small run: loss {rc.global_loss} vs "
                                 f"{rp.global_loss}")
    pairs = [(a.cpu(), b) for a, b in zip(
        tree_leaves(out["cuda"].runtime.global_params),
        tree_leaves(out["cpu"].runtime.global_params), strict=True)]
    gaps = [float((a - b).abs().max()) for a, b in pairs]
    if not all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in pairs):
        raise AssertionError(f"small run: fused parameters disagree; "
                             f"largest |diff| by leaf {gaps}")
    log(f"  small {cfg.name} run card vs CPU (conditioned weights): losses "
        f"{[round(r.global_loss, 6) for r in out['cuda'].records]} vs "
        f"{[round(r.global_loss, 6) for r in out['cpu'].records]}, "
        f"max |fused param diff|={max(gaps):.3e} ok")


# --------------------------------------------------------------------------
# phase 5: batch path equals streaming
# --------------------------------------------------------------------------
def last_round_updates(res):
    """(round index, the parties' bf16 models, their example counts) of the
    main path's last round, read back from the update queue."""
    rt = res.runtime
    last = rt.records[-1].round_idx
    topic = rt.queue.topic(f"updates/{rt.spec.job_id}")
    msgs = [m.value for m in topic.poll("smoke-check")
            if m.value["round"] == last]
    return last, [m["update"] for m in msgs], [m["n_examples"] for m in msgs]


def batch_path(torch, res):
    """FedAvg().fuse (fused_agg, bf16 out) of the last round's updates
    against the fold of the same updates (pair_fuse, fp32). Tolerance: the
    batch result is rounded to bf16, which may land one bf16 ulp away,
    2**-7 * |fold|, plus 2**-20 of the leaf's largest |fold| for the fp32
    sums taken in other orders near zero."""
    from repro_torch import tree_leaves
    from repro_torch.fl.fusion import FedAvg, FusionState
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse

    last, updates, n_ex = last_round_updates(res)
    alg = FedAvg()

    pair_fuse.launches = fused_agg.launches = 0
    fused = alg.fuse(updates, n_ex)
    torch.cuda.synchronize()
    launches = fused_agg.launches
    if launches <= 0:
        raise AssertionError("the batch path never launched fused_agg")

    st = FusionState()
    for u, n in zip(updates, n_ex):
        st = st.fold(u, alg.weight_of(n))
    fold = st.result()
    worst = 0.0
    for f, s in zip(tree_leaves(fused), tree_leaves(fold), strict=True):
        err = (f.float() - s).abs()
        tol = 2.0 ** -7 * s.abs() + 2.0 ** -20 * float(s.abs().max())
        if not bool((err <= tol).all()):
            raise AssertionError(f"batch != streaming: {float(err.max())}")
        worst = max(worst, float(err.max()))
    log(f"  batch (fused_agg, {launches} launches) vs streaming fold "
        f"(pair_fuse) on round {last}'s {len(updates)} updates: "
        f"max_abs_err={worst:.3e} ok")
    return launches


# --------------------------------------------------------------------------
# phase 6: the quantised path
# --------------------------------------------------------------------------
def quantized_path(torch, res):
    """The last round's real bf16 party models quantised to int8 on the
    card, fused with FedAvg's weights (one quant_agg launch per leaf),
    against fuse_updates of the same updates. Tolerance: the example's
    bound, 1.05 * sum_k w_k s_k + 1e-7 per leaf: half a quantisation step
    per update for the int8 rounding, the rest for the bf16 rounding of the
    exact fusion."""
    from repro_torch import tree_leaves
    from repro_torch.fl.fusion import FedAvg
    from repro_torch.kernels import fuse_quantized, fuse_updates, quantize_update
    from repro_torch.kernels.quant_agg import quant_agg

    last, updates, n_ex = last_round_updates(res)
    ws = [FedAvg().weight_of(n) for n in n_ex]
    weights = [w / sum(ws) for w in ws]
    t0 = time.perf_counter()
    qs, ss = zip(*(quantize_update(u) for u in updates))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0

    quant_agg.launches = 0
    t0 = time.perf_counter()
    fused_q = fuse_quantized(list(qs), list(ss), weights)
    torch.cuda.synchronize()
    t_fuse = time.perf_counter() - t0
    launches = quant_agg.launches
    n_leaves = len(tree_leaves(updates[0]))
    if launches != n_leaves:
        raise AssertionError(f"fuse_quantized made {launches} quant_agg "
                             f"launches for {n_leaves} leaves")

    exact = fuse_updates(updates, weights)
    worst = 0.0  # largest error over its bound
    for i, (a, b) in enumerate(zip(tree_leaves(exact), tree_leaves(fused_q),
                                   strict=True)):
        if b.dtype != torch.float32 or b.shape != a.shape:
            raise AssertionError(f"fused int8 leaf {b.dtype} {tuple(b.shape)}")
        err = float((a.float() - b).abs().max())
        bound = sum(w * float(tree_leaves(s)[i]) for w, s in zip(weights, ss))
        if not err <= 1.05 * bound + 1e-7:
            raise AssertionError(f"leaf {i}: int8 error {err} > bound {bound}")
        worst = max(worst, err / bound)
    log(f"  round {last}'s {len(updates)} updates: quantize_update "
        f"{t_quant:.3f} s, fuse_quantized ({launches} quant_agg launches) "
        f"{t_fuse:.3f} s (host clock, synchronised); every leaf within its "
        f"bound, largest error/bound {worst:.4f} ok")
    del qs, ss, fused_q, exact
    return launches


def serve_quantized_full(torch):
    """The serve_quantized example at qwen3-0.6b's full width on the card;
    it raises itself if a leaf's error exceeds its bound."""
    from repro_torch import configs
    from repro_torch.examples import serve_quantized

    cfg = configs.get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    out = serve_quantized.run(cfg, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ratio = max(e / b for e, b in zip(out["errs"], out["bounds"]))
    log(f"  serve_quantized.run({cfg.name}, {cfg.dtype}, K=4): max error "
        f"{max(out['errs']):.6f} (bound {max(out['bounds']):.6f}), largest "
        f"error/bound {ratio:.4f} over {len(out['errs'])} leaves; t_upd "
        f"fp32={out['t_upd_fp32']:.2f} s -> int8={out['t_upd_int8']:.2f} s; "
        f"{wall:.3f} s (host clock) ok")


# --------------------------------------------------------------------------
# phase 7: checkpoint round trip
# --------------------------------------------------------------------------
def checkpoint_round_trip(torch, res):
    """Save the main path's fused global model (bf16) and load it back onto
    the card ``like=`` itself: every leaf bit-equal, dtype and device
    kept."""
    from repro_torch import tree_leaves
    from repro_torch.ckpt import load_checkpoint, save_checkpoint

    params = res.runtime.global_params
    step = res.records[-1].round_idx + 1
    n_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        t0 = time.perf_counter()
        path = save_checkpoint(d, step, params)
        t_save = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        got_step, back = load_checkpoint(d, like=params)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if got_step != step:
        raise AssertionError(f"loaded step {got_step}, saved {step}")
    for a, b in zip(tree_leaves(params), tree_leaves(back), strict=True):
        if b.dtype != a.dtype or b.device != a.device or b.shape != a.shape:
            raise AssertionError(f"loaded leaf {b.dtype} {b.device} "
                                 f"{tuple(b.shape)}")
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError("checkpoint round trip changed a leaf")
    log(f"  {n_bytes / 1e9:.3f} GB of bf16 parameters ({size:,} B on disk): "
        f"save {t_save:.3f} s, load onto the card {t_load:.3f} s (host "
        f"clock); every leaf bit-equal ok")


# --------------------------------------------------------------------------
# phase 8: the simulation vehicles priced on the card
# --------------------------------------------------------------------------
def cost_table(torch, res, card):
    """The kernel cost table measured through the three CUDA kernels (CUDA
    events, mean of 10 launches after 3 warmups, cold L2), beside its
    roofline; dumped to chiprun_out/. A measured row faster than 0.95 x its
    roofline means a wrong byte count or timing. The full-size pair_fuse
    row keeps the reference's byte semantics (two fp32 operands of
    bytes / 4 elements); phase 4's probe times the real fold, an fp32
    accumulator and a bf16 update of every element. Both are one memory
    sweep, so the probe, scaled by the bytes each moves
    (``kernel_bytes_moved`` for the row, 10 B per element for the probe),
    may differ from the row by at most 25 %."""
    from repro_torch import tree_leaves
    from repro_torch.kernels import autotune

    torch.cuda.empty_cache()
    trace: list = []
    measured = autotune.build_cost_table(TABLE_SIZES, basis="measured",
                                         trace=trace)
    roof = autotune.build_cost_table(TABLE_SIZES, basis="roofline")
    device = {(t.kernel, t.n, t.bn, t.kb): t.graph_s for t in trace}
    log(f"  cost table on {card} (t_pair per pair, CUDA events, at the "
        f"searched launch shape: bn elements a block, kb elements a thread; "
        f"device time from a CUDA graph of the same launches):")
    log("  kernel,model_bytes,K,bn,kb,measured_ms,roofline_ms,"
        "measured/roofline,device/roofline")
    for m, r in zip(measured.entries, roof.entries, strict=True):
        spec = autotune.KERNELS[m.kernel]
        ratio = m.t_pair_s / r.t_pair_s
        dev = device[(m.kernel, m.model_bytes // spec.in_itemsize, m.bn,
                      m.kb)] / autotune._pairs(m.kernel, spec.k) / r.t_pair_s
        log(f"  {m.kernel},{m.model_bytes},{spec.k},{m.bn},{m.kb},"
            f"{m.t_pair_s * 1e3:.4f},{r.t_pair_s * 1e3:.4f},{ratio:.4f},"
            f"{dev:.4f}")
        if ratio < 0.95:
            raise AssertionError(f"{m.kernel} at {m.model_bytes} B: "
                                 f"measured faster than its roofline")
        if dev > KERNEL_LIMIT:
            raise AssertionError(f"{m.kernel} at {m.model_bytes} B: device "
                                 f"time {dev:.4f} x its roofline")
    full = measured.t_pair(TABLE_SIZES[-1])
    row_bytes = autotune.kernel_bytes_moved("pair_fuse", 2,
                                            TABLE_SIZES[-1] // 4)
    leaves = tree_leaves(res.runtime.global_params)
    probe_bytes = sum(t.numel() for t in leaves) * (
        4 + leaves[0].element_size() + 4)
    probe = res.runtime.t_pair0 * row_bytes / probe_bytes
    log(f"  pair_fuse at {TABLE_SIZES[-1]} B ({row_bytes:,} B moved): table "
        f"{full * 1e3:.4f} ms; phase 4's probe {res.runtime.t_pair0 * 1e3:.4f}"
        f" ms for {probe_bytes:,} B (host clock), scaled to the row's bytes "
        f"{probe * 1e3:.4f} ms; table / scaled probe {full / probe:.4f}")
    if abs(full / probe - 1.0) > 0.25:
        raise AssertionError("the cost table and the t_pair probe disagree")
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    measured.dump(out / "kernel_cost_table.json")
    log(f"  wrote {out / 'kernel_cost_table.json'}")
    return measured, trace


def fleets(table, res, card):
    """The main path's measured arrivals as a 16-job fleet, and the
    synthetic 16-job fleet, each under JIT and eager-AO on fresh platforms
    priced by the measured table. JIT must bill fewer container-seconds."""
    from repro_torch.api import Platform
    from repro_torch.fleet import fleet_from_measured, synthetic_fleet

    rt = res.runtime
    traces = {"measured x16": fleet_from_measured(
                  rt.spec, rt.measured_rounds, n_jobs=16),
              "synthetic x16": synthetic_fleet(16)}
    log(f"  fleets priced by the measured table ({card}; virtual clock):")
    for name, trace in traces.items():
        out = {}
        for strategy in ("jit", "eager_ao"):
            platform = Platform(cost_table=table)
            runner = platform.submit_fleet(trace, strategy)
            platform.run()
            if not runner.all_done:
                raise AssertionError(f"{name} {strategy}: jobs unfinished")
            out[strategy] = f = runner.result().fleet
            log(f"  {name} {strategy}: {f.rounds_done} rounds, "
                f"{f.container_seconds:.4f} container-s, latency p50 "
                f"{f.p50_latency_s:.4f} s p95 {f.p95_latency_s:.4f} s, "
                f"estimator calib_scale {platform.estimator.calib_scale:.1f}")
        jit, ao = (out[s].container_seconds for s in ("jit", "eager_ao"))
        log(f"  {name}: JIT saves {100.0 * (1.0 - jit / ao):.2f} % of "
            f"eager-AO's container-seconds")
        if not jit < ao:
            raise AssertionError(f"{name}: JIT billed {jit} >= eager-AO {ao}")


def online_service(table, card):
    """``Platform.serve`` with the burst knobs of the reference's online
    benchmark (18 mixed jobs, Poisson + diurnal arrivals, a 3x burst, the
    gold/silver/best_effort ladder by arrival index, a pool autoscaled
    from 2 between 1 and 8), priced by the measured table, run to drain."""
    import dataclasses

    from repro_torch.api import Platform
    from repro_torch.core import ClusterConfig
    from repro_torch.fleet import synthetic_fleet
    from repro_torch.online import (
        SLA_CLASSES, AdmissionConfig, AutoscalerConfig, TraceStream)

    cycle = ("gold", "silver", "best_effort")
    ladder = {**SLA_CLASSES,
              "gold": dataclasses.replace(SLA_CLASSES["gold"],
                                          lateness_p95_band_s=240.0),
              "silver": dataclasses.replace(SLA_CLASSES["silver"],
                                            lateness_p95_band_s=900.0)}
    stream = TraceStream(
        synthetic_fleet(18, "mixed", seed=0), timing="poisson",
        mean_interarrival_s=120.0, diurnal_period_s=2400.0,
        diurnal_amplitude=0.3, burst=(800.0, 2400.0, 3.0), seed=0)
    platform = Platform(ClusterConfig(capacity=2), cost_table=table)
    svc = platform.serve(
        stream, sla=lambda jt, idx: cycle[idx % len(cycle)],
        sla_classes=ladder,
        autoscaler=AutoscalerConfig(min_capacity=1, max_capacity=8),
        admission=AdmissionConfig(burst_window_s=300.0, burst_arrivals=4),
        window_s=600.0)
    report = svc.drain()
    if not svc.dashboard().done:
        raise AssertionError("the online service did not drain")
    f = report.fleet
    log(f"  online service priced by the measured table ({card}; virtual "
        f"clock): {json.dumps(report.summary())}")
    log(f"  online totals: {f.n_jobs} jobs, {f.rounds_done} rounds, "
        f"{f.container_seconds:.4f} container-s, latency p50 "
        f"{f.p50_latency_s:.4f} s p95 {f.p95_latency_s:.4f} s, "
        f"{svc.n_scale_ups} scale-ups, {svc.n_scale_downs} scale-downs, "
        f"{len(report.shed_jobs)} shed; drained ok")


# --------------------------------------------------------------------------
# phase 9: the other families at full width
# --------------------------------------------------------------------------
def free(torch) -> None:
    """Return what the previous phase's models held to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def family_path(torch, name: str, layers: int, condition: bool = False,
                over: dict | None = None):
    """``Platform().train`` of ``name`` at full width (bf16) with ``layers``
    of its layers (and the config's other fields in ``over``): 3 parties,
    2 FedAvg rounds on phase 4's data sizes, the
    initial model drawn on the card from the seed (and ``conditioned``
    with ``condition``). Every fold must go
    through pair_fuse, the eval loss must drop and stay finite, and the
    probe must predict one real fold. Returns (the run, its kernel
    launches)."""
    from repro_torch import configs
    from repro_torch.api import Platform
    from repro_torch.core.jobspec import FLJobSpec, PartySpec
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_config(name), num_layers=layers,
                              **(over or {}))
    n_params = M.n_params(cfg)
    job = FLJobSpec(
        job_id=f"{name}-smoke", model_arch=cfg.name,
        model_bytes=n_params * 2, aggregation_algorithm="fedavg", rounds=2,
        lr=0.05, batch_size=8,
        parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)},
    )
    log(f"{cfg.name}: L={layers} of {configs.get_config(name).num_layers} "
        f"d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
        f"hd={cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"bias={cfg.qkv_bias} experts={cfg.num_experts} "
        f"top-{cfg.num_experts_per_tok} shared={cfg.num_shared_experts} "
        f"{cfg.dtype}: {n_params:,} params ({n_params * 2 / 1e9:.3f} GB), "
        f"{job.n_parties} parties, {job.rounds} rounds"
        f"{', conditioned weights' if condition else ''}")
    free(torch)
    init = None
    if condition:
        init = conditioned(torch, M.init(cfg, torch.Generator(
            device="cuda").manual_seed(SEED)), torch.Generator().manual_seed(
            SEED))
    pair_fuse.launches = fused_agg.launches = 0
    t0 = time.perf_counter()
    res = Platform().train(cfg, job, n_sequences=48, eval_sequences=16,
                           seed=SEED, initial_params=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pair_fuse": pair_fuse.launches,
                "fused_agg": fused_agg.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rt = res.runtime
    with torch.no_grad():  # the runtime's initial model, drawn again
        if init is None:
            init = M.init(cfg, torch.Generator(
                device="cuda").manual_seed(SEED))
        batch = {k: torch.from_numpy(v.astype("int64")).cuda()
                 for k, v in rt.eval_data.items() if k != "domains"}
        loss0 = float(M.loss_fn(cfg, init, batch)[0])
        del init, batch
    for rec, measured in zip(res.records, rt.measured_rounds):
        log(f"  round {rec.round_idx}: eval loss {rec.global_loss:.6f}; "
            f"local training (host clock, s): "
            + ", ".join(f"{p}={t:.4f}" for p, (t, _) in measured.items()))
    log(f"  eval loss before={loss0:.6f} after="
        f"{res.records[-1].global_loss:.6f}; Platform.train wall={wall:.3f} s"
        f" (host clock, calibration, probe and eval included); peak device "
        f"memory={peak:.2f} GiB; launches {launches}")
    if launches["pair_fuse"] <= 0:
        raise AssertionError(f"{name}: no fold launched pair_fuse")
    check_trained(torch, cfg, res, loss0)
    fold_against_probe(torch, res)
    log(f"  peak device memory with the fold timed: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return res, launches


def moe_extras(torch, res) -> None:
    """The MoE config's batch path (``FedAvg().fuse`` through fused_agg) on
    its real updates against the streaming fold; and one training step's
    gradient computed twice, bit-equal (the dispatch and combine have a
    fixed order of additions, ``models/moe.py``)."""
    from repro_torch import tree_leaves

    batch_path(torch, res)
    log(f"  peak device memory with the batch path: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rt = res.runtime
    party = rt.parties["p0"]
    batch = party._to_device(next(party.loader.epoch(shuffle=False)))
    first, loss = party._grad_step(rt.global_params, batch)
    again, _ = party._grad_step(rt.global_params, batch)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                 tree_leaves(again)))
    log(f"  one training step's gradient (loss {float(loss):.6f}) repeated: "
        f"{'bit-equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("the MoE training step is not deterministic")
    del first, again


# --------------------------------------------------------------------------
# phase 10: the examples on the card
# --------------------------------------------------------------------------
def recorded_steps(losses: dict):
    """Patch ``Party.local_round`` so that every local step appends its
    loss to ``losses[party_id]`` (calibration is not recorded); returns
    the undo. ``local_round`` reads each step's loss on the host already,
    so the record adds no synchronisation."""
    from repro_torch.fl.party import Party

    local_round = Party.local_round

    def recording(self, global_params, epochs=1):
        step = self._step

        def counted(*a):
            out = step(*a)
            losses.setdefault(self.party_id, []).append(float(out[2]))
            return out

        self._step = counted
        try:
            return local_round(self, global_params, epochs)
        finally:
            del self._step

    Party.local_round = recording
    return lambda: setattr(Party, "local_round", local_round)


def examples(torch) -> None:
    """``federated_100m`` at its defaults (example-100m at full width and
    depth, 4 parties, 10 FedProx rounds of 192 sequences), ``quickstart``'s
    training half and ``multijob_scheduler``; each fold through pair_fuse.

    ``federated_100m`` must run its 10 rounds and price them on a finite
    timeline, and diverge where the JAX package's example does at these
    settings (``scripts/federated_100m_nan.py``, on the CPU): in round 0
    every party's first step starts near ln(V) and blows the model up
    (step 1's loss 7.7e8 to 8.7e11 in both packages), and its loss is no
    longer finite by step 2 (by step 3 for one party of the port's, bf16
    overflowing a step later), so every eval loss is NaN."""
    from repro_torch.examples import (federated_100m, multijob_scheduler,
                                      quickstart)
    from repro_torch.kernels.pair_fuse import pair_fuse

    free(torch)
    pair_fuse.launches = 0
    losses: dict = {}
    undo = recorded_steps(losses)
    t0 = time.perf_counter()
    try:
        out = federated_100m.run()
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = out["result"]
    log(f"  federated_100m: eval loss by round "
        f"{[r.global_loss for r in res.records]}; {res.metrics.strategy} "
        f"container-seconds {out['container_seconds']:.4f} (virtual clock); "
        f"mean t_rnd prediction error (rounds 2+) "
        f"{100 * out['t_rnd_pred_err']:.2f} %; wall {wall:.3f} s (host "
        f"clock); {pair_fuse.launches} pair_fuse launches; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    first_bad = {}
    for pid, xs in sorted(losses.items()):
        first_bad[pid] = next(
            (k for k, x in enumerate(xs) if x != x or abs(x) == float("inf")),
            None)
        log(f"  {pid}'s first local steps: losses {xs[:4]}; first "
            f"non-finite at step {first_bad[pid]}")
    if pair_fuse.launches <= 0:
        raise AssertionError("federated_100m never launched pair_fuse")
    timeline = (out["container_seconds"], out["t_rnd_pred_err"])
    if len(res.records) != 10 or not all(0 <= x < 1e9 for x in timeline):
        raise AssertionError(f"federated_100m: {len(res.records)} rounds, "
                             f"timeline {timeline}")
    diverged = sorted(losses) == [f"p{i}" for i in range(4)] and all(
        xs[0] < 20.0 and xs[1] > 1e6 and first_bad[pid] in (2, 3)
        for pid, xs in losses.items()) and all(
        r.global_loss != r.global_loss for r in res.records)
    if not diverged:
        raise AssertionError("federated_100m does not diverge where the "
                             "JAX package's example does")
    del out, res

    free(torch)
    pair_fuse.launches = 0
    t0 = time.perf_counter()
    res, ao = quickstart.train()  # raises itself if the loss did not drop
    torch.cuda.synchronize()
    log(f"  quickstart.train: {len(res.records)} rounds, loss "
        f"{res.records[0].global_loss:.6f} -> "
        f"{res.records[-1].global_loss:.6f}"
        f", JIT {res.metrics.container_seconds:.4f} vs always-on "
        f"{ao.container_seconds:.4f} container-s (virtual clock); wall "
        f"{time.perf_counter() - t0:.3f} s; {pair_fuse.launches} pair_fuse "
        f"launches; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if pair_fuse.launches <= 0:
        raise AssertionError("quickstart never launched pair_fuse")
    del res, ao

    _, metrics = multijob_scheduler.main()
    if sum(m.rounds_done for m in metrics.values()) != 12:
        raise AssertionError("multijob_scheduler: rounds missing")


# --------------------------------------------------------------------------
# phase 11: the launchers on the card
# --------------------------------------------------------------------------
def teacher_forced(torch, cfg, params, prompt, gen, image_embeds=None):
    """Logits of one full ``forward`` over the prompt and the generated
    tokens, at the positions that predicted ``gen`` (B, n, [K,] V). A
    sequence longer than one 256-query chunk is padded at its end to a
    whole number of chunks (the reference's attention and its SSD chunks
    of 256 need that): the forward is causal, so the padding changes no
    earlier position."""
    from repro_torch.models import model as M

    seq = torch.cat([prompt, gen[:, :-1]], dim=1)
    n = seq.shape[1]
    pad = (-n) % 256 if n > 256 else 0
    seq = torch.nn.functional.pad(seq, (0, 0) * (seq.dim() - 2) + (0, pad))
    with torch.no_grad():
        logits, _, _ = M.forward(cfg, params, seq, image_embeds=image_embeds)
    s = prompt.shape[1]
    out = logits[:, s - 1:s - 1 + gen.shape[1]].clone()
    del logits
    return out


def agreement(torch, cfg, params, prompt, out, image_embeds=None) -> dict:
    """``share``: of ``out``'s greedy tokens, those a teacher-forced forward
    over the same tokens also picks; ``by_pos``: each position's largest
    gap between their logits (B, n); ``gap`` and ``median``: its largest
    and median; ``scale``: the forward's largest |logit| where the gap is
    largest."""
    tf = teacher_forced(torch, cfg, params, prompt, out.tokens, image_embeds)
    share = float((tf.argmax(-1) == out.tokens).float().mean())
    by_pos = (tf - out.logits).abs().flatten(2).amax(-1)
    worst = int(by_pos.argmax())
    return {"share": share, "by_pos": by_pos, "gap": float(by_pos.max()),
            "median": float(by_pos.median()),
            "scale": float(tf.flatten(0, 1)[worst].abs().max())}


def recorded_routes():
    """Patch ``moe._route`` so that every call appends its top-k experts
    (B, S, k) to a list; returns (the list, the undo)."""
    from repro_torch.models import moe

    calls: list = []
    route = moe._route

    def recording(cfg, router, x):
        out = route(cfg, router, x)
        calls.append(out[2])
        return out

    moe._route = recording
    return calls, lambda: setattr(moe, "_route", route)


def routing_flips(torch, dec, fwd, layers: int):
    """(B, n) bool: the positions at which some layer's router sends the
    token to other experts in the decode than in the teacher-forced
    forward. ``dec`` holds the prefill's ``layers`` router calls, then
    ``layers`` a decode step; ``fwd`` the forward's ``layers`` calls.
    Position j predicts after PROMPT + j tokens, as ``agreement``'s."""
    steps = (len(dec) - layers) // layers
    flips = None
    for i in range(layers):
        d = torch.cat([dec[i][:, -1:]] + [dec[layers * (1 + j) + i]
                                          for j in range(steps)], dim=1)
        f = fwd[i][:, PROMPT - 1:PROMPT + steps]
        diff = (d.sort(-1).values != f.sort(-1).values).any(-1)
        flips = diff if flips is None else flips | diff
    return flips


def serve_full(torch, name: str, batch: int, card: str,
               layers: int | None = None) -> dict:
    """``launch.serve.generate`` of ``name`` at full width (bf16) and full
    depth, or ``layers`` of its layers, on the card: a prompt of PROMPT
    tokens (PROMPT x K codebook tokens for an audio config) prefilled into
    PROMPT + TOKENS slots, then TOKENS greedy decode steps, each
    synchronised. A VLM gets zero image embeddings (B, P, d), as the
    reference's serve launcher feeds. The weights and the prompt are drawn
    on the card from the seed. Fails unless every token lies in the
    vocabulary, every logit is finite, the cache's ``t`` is PROMPT + TOKENS
    and peak memory stays under 80 GB. The decode bound reads every weight
    and the whole cache (KV slots, recurrent states, conv tails, image
    K/V) once a step.

    Then a teacher-forced forward over the same tokens: the share of greedy
    tokens it also picks, and the largest logit gap (reported). For a
    config with attention and without qk_norm the seeded weights give no
    reading: their forward is chaotic, a 1e-7 change of the weights moving
    the logits by up to 4.7 (``scripts/torch_forward_chaos.py``), so the
    comparison is repeated, untimed, from ``conditioned`` weights. The
    MoE's capacity grows with the sequence (``models/moe.py``), so its
    prefill, its one-token decode and the longer forward drop different
    tokens; the conditioned comparison gives it a capacity factor at which
    no expert drops a token, and counts the positions at which a router
    still sends a token to other experts in the decode than in the
    forward (``routing_flips``)."""
    from repro_torch import configs, tree_leaves
    from repro_torch.launch import serve
    from repro_torch.launch.roofline import bandwidth_time_s
    from repro_torch.models import model as M

    cfg = configs.get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    free(torch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    tok_shape = (batch, PROMPT) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks else ())
    prompt = torch.randint(
        0, cfg.vocab_size, tok_shape, device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    img = None
    if cfg.num_image_tokens:
        img = torch.zeros((batch, cfg.num_image_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device="cuda")
    serve.generate(cfg, params, prompt[:, :64], 4, 68,
                   image_embeds=img)  # warm the libraries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = serve.generate(cfg, params, prompt, TOKENS, PROMPT + TOKENS,
                         image_embeds=img, timed=True, keep_logits=True)
    peak = torch.cuda.max_memory_allocated()
    gen, t = out.tokens, int(out.cache["t"])
    in_vocab = bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
    kv_bytes = sum(x.numel() * x.element_size()
                   for x in tree_leaves(out.cache))
    p_bytes = M.n_params(cfg) * 2
    steady = out.step_s[8:]
    ms = statistics.median(steady) * 1e3
    bound = bandwidth_time_s(p_bytes + kv_bytes) * 1e3
    out.cache = None
    a = agreement(torch, cfg, params, prompt, out, img)
    agree, gap, med, scale = a["share"], a["gap"], a["median"], a["scale"]
    row = {"config": name, "layers": cfg.num_layers, "batch": batch,
           "prompt": PROMPT, "tokens": TOKENS,
           "prefill_ms": out.prefill_s * 1e3, "decode_ms": ms,
           "decode_ms_min": min(steady) * 1e3,
           "decode_ms_max": max(steady) * 1e3,
           "tokens_per_s": batch * 1e3 / ms,
           "decode_bound_ms": bound, "peak_gib": peak / 2**30,
           "kv_cache_gb": kv_bytes / 1e9, "params_gb": p_bytes / 1e9,
           "greedy_agree": agree, "max_logit_gap": gap,
           "median_logit_gap": med}
    log(f"  serve {name} ({cfg.num_layers} layers, B {batch}, prompt "
        f"{PROMPT}, {TOKENS} tokens; {card}): prefill {row['prefill_ms']:.3f}"
        f" ms, decode {ms:.4f} ms per token (median of steps 9-{TOKENS}, "
        f"{row['decode_ms_min']:.4f}-{row['decode_ms_max']:.4f}; host clock,"
        f" synchronised), {row['tokens_per_s']:.1f} tokens/s; bound "
        f"{bound:.4f} ms ({p_bytes / 1e9:.3f} GB of weights + "
        f"{kv_bytes / 1e9:.3f} GB of cache at 3.35 TB/s); peak "
        f"{row['peak_gib']:.2f} GiB; t={t}; greedy tokens the teacher-forced"
        f" forward also picks {100 * agree:.2f} %, largest logit gap "
        f"{gap:.4e} (median over positions {med:.4e}; largest |logit| "
        f"there {scale:.4e}); first row {gen[0].flatten()[:8].tolist()}")
    if not (out.finite and in_vocab and t == PROMPT + TOKENS
            and tuple(gen.shape[:2]) == (batch, TOKENS + 1)
            and peak < CARD_BYTES):
        raise AssertionError(f"serve {name}: finite={out.finite} "
                             f"in_vocab={in_vocab} t={t} shape="
                             f"{tuple(gen.shape)} peak={peak}")
    if cfg.num_heads and not cfg.qk_norm:
        params = conditioned(torch, params, torch.Generator().manual_seed(SEED))
        if cfg.num_experts:  # a capacity of S slots an expert drops nothing
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
        calls, undo = recorded_routes()
        try:
            out = serve.generate(cfg, params, prompt, TOKENS, PROMPT + TOKENS,
                                 image_embeds=img, keep_logits=True)
            out.cache = None
            n_dec = len(calls)
            a = agreement(torch, cfg, params, prompt, out, img)
        finally:
            undo()
        row["conditioned_greedy_agree"] = a["share"]
        row["conditioned_max_logit_gap"] = a["gap"]
        row["conditioned_median_logit_gap"] = a["median"]
        log(f"  from conditioned weights: greedy tokens the teacher-forced "
            f"forward also picks {100 * a['share']:.2f} %, largest logit gap "
            f"{a['gap']:.4e} (median over positions {a['median']:.4e}; "
            f"largest |logit| there {a['scale']:.4e}); all finite: "
            f"{out.finite}")
        if cfg.num_experts:
            flips = routing_flips(torch, calls[:n_dec], calls[n_dec:],
                                  cfg.num_layers)
            rest = a["by_pos"][~flips]
            row["conditioned_routing_flips"] = int(flips.sum())
            log(f"  routing: at {int(flips.sum())} of {flips.numel()} "
                f"positions some layer sends the token to other experts in "
                f"the decode than in the forward; the largest logit gap at "
                f"the "
                f"{rest.numel()} others {float(rest.max()):.4e}")
        del calls
    del params, prompt, out
    return row


def decode_profile(torch, card: str) -> dict:
    """Where a decode step of qwen3-0.6b (bf16, B 8, prompt 1024, cache of
    1152 slots) goes: 20 steps unsynchronised (host enqueue and wall time
    a step), 5 under ``torch.profiler`` (kernels a step, device busy time a
    step, so the device's idle share), and the step captured as one CUDA
    graph and replayed. The capture fails if the step waits on the host
    anywhere (``t`` and the ring slot stay on the device); the graph's
    logits against an eager step from the same cache are reported."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, tree_map
    from repro_torch.models import model as M

    cfg = configs.get_config("qwen3-0.6b")
    free(torch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    prompt = torch.randint(
        0, cfg.vocab_size, (8, PROMPT), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    _, cache = M.prefill(cfg, params, prompt, capacity=PROMPT + TOKENS)
    tok = prompt[:, -1:].clone()
    for _ in range(3):
        M.decode_step(cfg, params, cache, tok)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        M.decode_step(cfg, params, cache, tok)
    enqueue = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            M.decode_step(cfg, params, cache, tok)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 5 / 1e3  # us -> ms
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            M.decode_step(cfg, params, cache, tok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits_g, _ = M.decode_step(cfg, params, cache, tok)
    twin = tree_map(torch.clone, cache)
    logits_e, _ = M.decode_step(cfg, params, twin, tok)
    graph.replay()
    diff = float((logits_g - logits_e).abs().max())
    del twin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        graph.replay()
    torch.cuda.synchronize()
    replay = (time.perf_counter() - t0) / n
    row = {"enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
           "kernels_per_step": len(kernels) / 5, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3),
           "graph_replay_ms": replay * 1e3, "graph_vs_eager_max_diff": diff}
    log(f"  qwen3-0.6b decode step (B 8, cache 1152; {card}): host enqueue "
        f"{row['enqueue_ms']:.3f} ms, wall {row['wall_ms']:.3f} ms a step "
        f"(20 unsynchronised, host clock); {row['kernels_per_step']:.0f} "
        f"kernels and {busy:.3f} ms of device time a step (torch.profiler),"
        f" idle share {row['idle_share']:.4f}; captured as one CUDA graph "
        f"(no host sync in the step): replay {row['graph_replay_ms']:.3f} ms"
        f" a step, logits against an eager step {diff:.3e}")
    del params, cache, graph, logits_g, logits_e
    return row


def decode_matches_forward(torch, name: str = "qwen3-0.6b") -> float:
    """``name`` at full width and depth in fp32 (TF32 off): 32 greedy
    decode steps after a prompt of 256 against a teacher-forced forward over
    the same tokens, within the reference's ``test_decode_matches_full_
    forward`` bound, rtol / atol 2e-2. A config with attention and without
    qk_norm runs from ``conditioned`` weights: from the seeded ones its
    forward is chaotic (``serve_full``), and the decode's other order of
    fp32 sums would read as a gap. Returns the largest gap."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_config(name), dtype="float32")
    free(torch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    weights = "seeded"
    if cfg.num_heads and not cfg.qk_norm:
        params = conditioned(torch, params, torch.Generator().manual_seed(SEED))
        weights = "conditioned"
    prompt = torch.randint(
        0, cfg.vocab_size, (2, 256), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    out = serve.generate(cfg, params, prompt, 32, 256 + 32, keep_logits=True)
    tf = teacher_forced(torch, cfg, params, prompt, out.tokens)
    err = (out.logits - tf).abs()
    gap = float(err.max())
    ok = bool((err <= 2e-2 + 2e-2 * tf.abs()).all())
    log(f"  decode == forward, {cfg.name} {cfg.num_layers} layers fp32 "
        f"({weights} weights), B 2, prompt 256, 32 tokens: largest logit gap"
        f" {gap:.4e} (bound 2e-2 + 2e-2 |logit|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: decode does not match the full "
                             f"forward")
    del params, out, tf, err
    return gap


def train_full(torch) -> dict:
    """``launch.train.main`` on the card: qwen3-0.6b at full width and depth
    (bf16 parameters, fp32 AdamW moments), 5 steps of batch 8 x 128 tokens.
    It must return 0 with every loss finite, and the loss at step 4 below
    the loss at step 0."""
    import contextlib
    import io

    from repro_torch.launch import train

    argv = ["--arch", "qwen3-0.6b", "--steps", "5", "--seq-len", "128",
            "--batch", "8"]
    free(torch)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    steps = [(float(m[1]), float(m[2])) for m in re.finditer(
        r"step \d+: loss=(\S+) \((\S+)s\)", text)]
    losses = [x for x, _ in steps]
    row = {"rc": rc, "losses": losses,
           "step_s": statistics.median(s for _, s in steps[1:]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "wall_s": wall}
    log(f"  train.main({' '.join(argv)}): rc {rc}; losses {losses}; step "
        f"{row['step_s'] * 1e3:.2f} ms (median of steps 1-4, host clock, "
        f"synchronised by reading the loss); peak {row['peak_gib']:.2f} GiB;"
        f" {wall:.3f} s in all (initialisation included)")
    if not (rc == 0 and len(losses) == 5
            and all(x == x and abs(x) < 1e9 for x in losses)
            and losses[4] < losses[0]):
        raise AssertionError(f"train launcher: rc {rc}, losses {losses}")
    return row


def decode_card_vs_cpu(torch, cfg) -> float:
    """Prefill of 16 tokens (with 16 image tokens for a VLM) and 8 decode
    steps fed the CPU's greedy tokens, of ``cfg`` (a small fp32 config), on
    the card and on the CPU from the same ``conditioned`` weights: logits
    and caches within rtol 1e-4 / atol 1e-5. Returns the largest logit
    gap."""
    from repro_torch import tree_leaves, tree_map
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    gen = torch.Generator().manual_seed(3)
    params = conditioned(torch, M.init(cfg, torch.Generator().manual_seed(
        SEED)), torch.Generator().manual_seed(SEED))
    prompt = torch.randint(0, cfg.vocab_size, (2, 16) + (
        (cfg.num_codebooks,) if cfg.num_codebooks else ()),
        dtype=torch.int32, generator=gen)
    img = None
    if cfg.num_image_tokens:
        img = torch.randn((2, cfg.num_image_tokens, cfg.d_model),
                          generator=gen)
    feed = serve.generate(cfg, params, prompt, 8, 24,
                          image_embeds=img).tokens[:, :8]

    def fed(dev):
        p = tree_map(lambda x: x.to(dev), params)
        logits, cache = M.prefill(cfg, p, prompt.to(dev), capacity=24,
                                  image_embeds=None if img is None
                                  else img.to(dev))
        outs = [logits[:, -1:]]
        for i in range(feed.shape[1]):
            logits, cache = M.decode_step(cfg, p, cache,
                                          feed[:, i:i + 1].to(dev))
            outs.append(logits)
        return torch.cat(outs, dim=1).cpu(), tree_map(lambda x: x.cpu(),
                                                      cache)

    want, want_c = fed("cpu")
    got, got_c = fed("cuda")
    gap = float((got - want).abs().max())
    same = torch.allclose(got, want, rtol=1e-4, atol=1e-5) and all(
        torch.allclose(a.float(), b.float(), rtol=1e-4, atol=1e-5)
        for a, b in zip(tree_leaves(got_c), tree_leaves(want_c), strict=True))
    log(f"  {cfg.name} ({cfg.num_layers} layers) prefill + 8 decode steps, "
        f"card vs CPU: largest logit gap {gap:.3e} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{cfg.name}: decode on the card differs")
    return gap


def launchers_card_vs_cpu(torch) -> None:
    """The card against the CPU at reduced sizes (2 layers, d_model 64,
    vocab 128, fp32) from the same ``conditioned`` weights: ``decode_card_
    vs_cpu`` for qwen3-0.6b, qwen2.5-14b, qwen2-moe-a2.7b and
    llama4-scout-17b-a16e; and 3
    ``make_train_step`` steps (AdamW) of qwen3-0.6b, losses within rtol
    1e-4."""
    from repro_torch import configs, tree_map
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    def reduced(name):
        return configs.get_config(name).reduced(
            num_layers=2, d_model=64, vocab_size=128, dtype="float32")

    for name in ("qwen3-0.6b", "qwen2.5-14b", "qwen2-moe-a2.7b",
                 "llama4-scout-17b-a16e"):
        decode_card_vs_cpu(torch, reduced(name))

    cfg = reduced("qwen3-0.6b")
    init = conditioned(torch, M.init(cfg, torch.Generator().manual_seed(SEED)),
                       torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(4)
    batches = []
    for _ in range(3):
        tok = torch.randint(0, 128, (4, 32), dtype=torch.int32, generator=gen)
        batches.append({"tokens": tok, "labels": torch.roll(tok, -1, 1)})
    losses = []  # the card's, then the CPU's
    for dev in ("cuda", "cpu"):
        step = steps.make_train_step(cfg)
        params = tree_map(lambda x: x.to(dev), init)
        state = adamw(3e-4).init(params)
        losses.append([])
        for b in batches:
            params, state, m = step(params, state,
                                    {k: v.to(dev) for k, v in b.items()})
            losses[-1].append(float(m["loss"]))
    ok = all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(*losses))
    log(f"  {cfg.name} 3 AdamW train steps, card vs CPU: losses "
        f"{losses[0]} vs {losses[1]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train steps on the card differ from the CPU")


def launchers(torch, card: str) -> None:
    """Phase 11, with its summary line for PERF.md."""
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg

    pair_fuse.launches = fused_agg.launches = quant_agg.launches = 0
    rows = [serve_full(torch, name, batch, card) for name, batch in SERVES]
    rows += [serve_full(torch, name, batch, card, layers)
             for name, layers, batch in CUT_SERVES]
    prof = decode_profile(torch, card)
    gap = decode_matches_forward(torch)
    tr = train_full(torch)
    free(torch)
    launchers_card_vs_cpu(torch)
    log(f"  kernel launches in phase 11: pair_fuse {pair_fuse.launches}, "
        f"fused_agg {fused_agg.launches}, quant_agg {quant_agg.launches} "
        f"(no TPU kernel lies on the serve or train path)")
    log("  phase 11 summary: " + json.dumps(
        {"card": card, "serve": rows, "decode_profile": prof,
         "decode_vs_forward_gap": gap, "train": tr}))
    return rows, tr


# --------------------------------------------------------------------------
# phase 12: the SSM, RG-LRU hybrid, audio and VLM families
# --------------------------------------------------------------------------
def smoke_models_on_card() -> None:
    """``scripts/torch_smoke_models.py`` on the card: every architecture's
    reduced variant through forward, loss and gradient, prefill and one
    decode step (it raises if a number is not finite)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "torch_smoke_models.py"
    spec = importlib.util.spec_from_file_location("torch_smoke_models", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cuda"])


def recurrent_families(torch, card: str) -> None:
    """Phase 12, with its summary line for PERF.md."""
    from repro_torch import configs
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg

    trained = []
    for name, layers, condition in RECURRENT_TRAIN:
        res, launches = family_path(torch, name, layers, condition)
        trained.append({
            "config": name, "layers": layers, "conditioned": condition,
            "pair_fuse_launches": launches["pair_fuse"],
            "eval_losses": [r.global_loss for r in res.records],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        del res

    pair_fuse.launches = fused_agg.launches = quant_agg.launches = 0
    rows = [serve_full(torch, name, batch, card, layers)
            for name, layers, batch in RECURRENT_SERVES]
    gaps = {name: decode_matches_forward(torch, name)
            for name in ("mamba2-130m", "recurrentgemma-9b")}
    free(torch)
    small = {"mamba2-130m": dict(num_layers=2, ssm_head_dim=32),
             "recurrentgemma-9b": dict(num_layers=5),
             "musicgen-large": dict(num_layers=2),
             "llama-3.2-vision-90b": dict(num_layers=5)}
    for name, over in small.items():
        decode_card_vs_cpu(torch, configs.get_config(name).reduced(
            d_model=64, vocab_size=128, dtype="float32", **over))
    smoke_models_on_card()
    serve_launches = {"pair_fuse": pair_fuse.launches,
                      "fused_agg": fused_agg.launches,
                      "quant_agg": quant_agg.launches}
    log(f"  kernel launches in phase 12 after the training runs: "
        f"{serve_launches} (no TPU kernel lies on the serve path)")
    log("  phase 12 summary: " + json.dumps(
        {"card": card, "train": trained, "serve": rows,
         "decode_vs_forward_gap": gaps, "serve_launches": serve_launches}))
    return rows

# --------------------------------------------------------------------------
# phase 17: Nemotron-3-Nano's cut
# --------------------------------------------------------------------------
def nemotron_cut():
    """(the port's config of the cut, the published keys the reference
    reads), both from the configuration file."""
    from repro_torch import configs

    spec = json.loads(NEMOTRON_FILE.read_text())
    run = spec["run"]
    cfg = dataclasses.replace(configs.get_config(NEMOTRON), **{
        k: run[k] for k in ("num_layers", "expert_first", "experts_held",
                            "vocab_size")})
    return cfg, spec


def fp8_weights(torch, tree):
    """``tree`` with every weight rounded through float8 e4m3, each leaf
    scaled so that its largest magnitude is e4m3's largest (448)."""
    from repro_torch import tree_map

    def rnd(a):
        scale = 448.0 / a.float().abs().max().clamp(min=1e-30)
        return ((a.float() * scale).to(torch.float8_e4m3fn).float()
                / scale).to(a.dtype)

    return tree_map(rnd, tree)


def without(tree, key: str):
    """``tree`` with every leaf (or subtree) named ``key`` replaced by
    zeros of its shape."""
    out = {}
    for k, v in tree.items():
        if k == key:
            out[k] = ({kk: vv * 0 for kk, vv in v.items()}
                      if isinstance(v, dict) else v * 0)
        elif isinstance(v, dict):
            out[k] = without(v, key)
        else:
            out[k] = v
    return out


def rel_gap(got, want) -> float:
    """||got - want|| / ||want|| over every element, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def nemotron_agreement(torch, cfg, spec, params, tokens) -> dict:
    """The port's bf16 logits of ``tokens`` against the float32
    reference's on the same ``params`` (the cut's weights), and the same
    forward in fp8 weights, without the shared expert and without the
    correction bias; the routing counters of the bf16 forward, beside
    the reference's count of held assignments."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "bench"))
    from fedbench.reference import nemotron_h as ref
    from repro_torch.models import model as M
    from repro_torch.obs.trace import Tracer

    tracer = Tracer(clock="wall")
    with torch.no_grad():
        logits = M.forward(cfg, params, tokens, tracer=tracer)[0]
        counts = {}
        want = ref.forward(spec, params, tokens, cfg.expert_first, counts)
        gaps = {"bf16": rel_gap(logits, want)}
        del logits
        for label, tree in (
                ("fp8_weights", fp8_weights(torch, params)),
                ("no_shared_expert", without(params, "shared")),
                ("no_correction_bias",
                 without(params, "e_score_correction_bias"))):
            gaps[label] = rel_gap(M.forward(cfg, tree, tokens)[0], want)
            del tree
    read = {k: tracer.metrics.counter(f"moe.{k}").n
            for k in ("assignments", "held_assignments", "dropped")}
    return {"gaps": gaps, "counters": read,
            "reference_held_assignments": counts["held_assignments"],
            "held_share": read["held_assignments"] / read["assignments"],
            "logit_rms": float(want.double().pow(2).mean().sqrt())}


def nemotron_phase(torch, card: str) -> dict:
    """Phase 17, with its summary line for PERF.md."""
    from repro_torch.models import model as M

    cfg, spec = nemotron_cut()
    res, launches = family_path(torch, NEMOTRON, cfg.num_layers,
                                condition=True, over={
                                    k: getattr(cfg, k) for k in (
                                        "expert_first", "experts_held",
                                        "vocab_size")})
    trained = {"eval_losses": [r.global_loss for r in res.records],
               "pair_fuse_launches": launches["pair_fuse"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del res
    free(torch)
    params = conditioned(torch, M.init(cfg, torch.Generator(
        device="cuda").manual_seed(SEED)), torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    tokens = torch.randint(0, cfg.vocab_size, NEMOTRON_BATCH, generator=gen,
                           device="cuda")
    t0 = time.perf_counter()
    agree = nemotron_agreement(torch, cfg, spec, params, tokens)
    agree["seconds"] = time.perf_counter() - t0
    del params
    free(torch)
    g = agree["gaps"]
    log(f"  {NEMOTRON} logits (B {NEMOTRON_BATCH[0]} x S {NEMOTRON_BATCH[1]},"
        f" conditioned weights) against the float32 reference, ||port - "
        f"ref|| / ||ref||: bf16 {g['bf16']:.6f}, fp8 weights "
        f"{g['fp8_weights']:.6f}, no shared expert "
        f"{g['no_shared_expert']:.6f}, no correction bias "
        f"{g['no_correction_bias']:.6f}; tolerance {NEMOTRON_TOL}")
    c = agree["counters"]
    log(f"  routing: moe.assignments {c['assignments']}, "
        f"moe.held_assignments {c['held_assignments']} (the reference "
        f"{agree['reference_held_assignments']}), held / all "
        f"{agree['held_share']:.6f}, moe.dropped {c['dropped']}")
    summary = {"card": card, "train": trained, **agree}
    log("  phase 17 summary: " + json.dumps(summary))
    if c["dropped"]:
        raise AssertionError("the dropless MoE dropped an assignment")
    if NEMOTRON_TOL is not None:
        if not g["bf16"] <= NEMOTRON_TOL:
            raise AssertionError(f"bf16 logits {g['bf16']} over the "
                                 f"tolerance {NEMOTRON_TOL}")
        for label in ("fp8_weights", "no_shared_expert",
                      "no_correction_bias"):
            if not g[label] > NEMOTRON_TOL:
                raise AssertionError(f"{label} passes the tolerance: "
                                     f"{g[label]}")
    return summary


# --------------------------------------------------------------------------
# phase 13: the roofline of the launchers and the launch-shape search
# --------------------------------------------------------------------------
def local_steps(res) -> dict:
    """Phase 4's local training: seconds a local step (each party-round's
    host time over its steps of ``batch_size``), by round and party."""
    rt = res.runtime
    steps = {pid: -(-p.n_examples // rt.spec.batch_size)
             for pid, p in rt.parties.items()}
    per_step = [t / steps[pid] for measured in rt.measured_rounds
                for pid, (t, _) in measured.items()]
    return {"steps_per_party_round": sorted(set(steps.values())),
            "step_s": per_step, "batch": rt.spec.batch_size,
            "seq_len": int(rt.eval_data["tokens"].shape[1])}


def roofline_rows(p4, serve_rows, train_row) -> list:
    """Each launcher run of phases 11 and 12 and phase 4's local step:
    measured time beside ``analytic_roofline(cfg, shape, 1, 0.0, H100)``'s
    compute and memory terms, their ratio, and the hand bound where the
    phase took one (weights + cache over 3.35 TB/s, decode only)."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import analytic_roofline

    def cfg_of(name, layers):
        cfg = configs.get_config(name)
        return cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers)

    runs = [("phase 4 local step (SGD)", cfg_of("qwen3-0.6b", None),
             InputShape("local", p4["seq_len"], p4["batch"], "train"),
             statistics.median(p4["step_s"]) * 1e3, None),
            ("phase 11 train.main step (AdamW)", cfg_of("qwen3-0.6b", None),
             InputShape("train", 128, 8, "train"),
             train_row["step_s"] * 1e3, None)]
    for r in serve_rows:
        cfg = cfg_of(r["config"], r["layers"])
        runs.append((f"{r['config']} prefill", cfg, InputShape(
            "prefill", r["prompt"], r["batch"], "prefill"),
            r["prefill_ms"], None))
        runs.append((f"{r['config']} decode", cfg, InputShape(
            "decode", r["prompt"] + r["tokens"], r["batch"], "decode"),
            r["decode_ms"], r["decode_bound_ms"]))
    out = []
    for label, cfg, shape, ms, hand in runs:
        rl = analytic_roofline(cfg, shape, 1, 0.0, H100)
        bound = max(rl.compute_s, rl.memory_s) * 1e3
        row = {"run": label, "config": cfg.name, "layers": cfg.num_layers,
               "batch": shape.global_batch, "seq": shape.seq_len,
               "kind": shape.kind, "ms": ms,
               "compute_ms": rl.compute_s * 1e3,
               "memory_ms": rl.memory_s * 1e3, "dominant": rl.dominant,
               "over_roofline": ms / bound, "hand_bound_ms": hand}
        out.append(row)
        log(f"  {label} ({cfg.name}, {cfg.num_layers} layers, B "
            f"{shape.global_batch} x {shape.seq_len}, {shape.kind}): "
            f"{ms:.4f} ms; roofline compute {row['compute_ms']:.4f} ms, "
            f"memory {row['memory_ms']:.4f} ms ({rl.dominant}); measured / "
            f"roofline {row['over_roofline']:.2f}"
            + (f"; hand bound {hand:.4f} ms" if hand is not None else ""))
    return out


def flops_on_card(torch, train_row) -> dict:
    """qwen3-0.6b's B 8 x 128 train step (``launch.steps``' AdamW step) on
    the card under ``FlopCounterMode``: the count must equal its meta
    count (``launch.dryrun``) exactly, operator by operator. With phase
    11's step time it gives the achieved rate and its share of the bf16
    peak."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import analytic_roofline
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = configs.get_config("qwen3-0.6b")
    shape = InputShape("train", 128, 8, "train")
    fn, meta_args, _ = steps.build(cfg, shape)
    _, meta, meta_ops = dryrun.counted_flops(fn, *meta_args)
    free(torch)
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    tok = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda",
                        dtype=torch.int32,
                        generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    _, card, card_ops = dryrun.counted_flops(
        fn, params, adamw(3e-4).init(params), batch)
    torch.cuda.synchronize()
    del params, tok, batch
    analytic = analytic_roofline(cfg, shape, 1, 0.0, H100).flops
    rate = card / train_row["step_s"]
    row = {"counted_card": card, "counted_meta": meta, "analytic": analytic,
           "by_op": card_ops, "tflops_per_s": rate / 1e12,
           "share_of_bf16_peak": rate / H100.peak_flops_bf16}
    log(f"  qwen3-0.6b train step B 8 x 128 on the card: {card:.6e} FLOPs "
        f"counted {card_ops}; on meta tensors {meta:.6e}; analytic "
        f"{analytic:.6e} (counted / analytic {card / analytic:.4f}); at "
        f"phase 11's {train_row['step_s'] * 1e3:.2f} ms a step "
        f"{row['tflops_per_s']:.3f} TFLOP/s, {100 * row['share_of_bf16_peak']:.3f}"
        f" % of the bf16 peak")
    if card != meta or card_ops != meta_ops:
        raise AssertionError("the card's FLOP count differs from the meta "
                             "count of the same step")
    return row


def launch_shape_search(torch, card: str, table_rows) -> dict:
    """The launch-shape search on the card: phase 8's cost-table sizes
    (fp32; int8 for quant_agg; K = 2 / 8 / 8) and every distinct leaf size
    of qwen3-0.6b at the main path's operands (pair_fuse folding a bf16
    update into the fp32 accumulator, fused_agg over 3 bf16 updates,
    quant_agg over 3 int8 rows). For each kernel and size: the default
    shape and the best (least device time), each as eager and CUDA-graph
    time, against the bound; the host launch cost and the per-block
    allowance fitted from the rows. Every row goes to
    chiprun_out/launch_shape_search.json."""
    from repro_torch import configs, tree_leaves
    from repro_torch.kernels import autotune
    from repro_torch.models import model as M

    cfg = configs.get_config("qwen3-0.6b")
    sizes = sorted({math.prod(s.shape)
                    for s in tree_leaves(M.param_specs(cfg))})
    rows = list(table_rows)
    for n in sizes:
        rows += autotune.search("pair_fuse", n, 2, "cuda", torch.bfloat16)
        rows += autotune.search("fused_agg", n, 3, "cuda", torch.bfloat16)
        rows += autotune.search("quant_agg", n, 3, "cuda")
    over = autotune.measure_overheads("cuda")
    block_s = autotune.fit_block_s(rows)
    log(f"  host launch cost {over['launch_host_s'] * 1e6:.3f} us a call "
        f"(host clock); one smallest-block launch {over['launch_device_s'] * 1e6:.3f}"
        f" us of device time (CUDA graph); per-block allowance fitted "
        f"{block_s * 1e9:.4f} ns, floored at 0: {max(0.0, block_s) * 1e9:.4f}"
        f" ns (autotune.BLOCK_S {autotune.BLOCK_S * 1e9:.4f} ns; {card})")
    log("  kernel,n,K,update_bytes,default bn/kb,default eager_ms,"
        "default graph_ms,best bn/kb,best eager_ms,best graph_ms "
        "(spread),bound_ms,best graph/bound,best eager/bound,"
        "best beats default beyond the spread")
    groups: dict = {}
    for r in rows:
        groups.setdefault((r.kernel, r.n, r.k, r.update_itemsize), []
                          ).append(r)
    summary = []
    for (kernel, n, k, usize), g in groups.items():
        d, b = autotune.default_of(g), autotune.best(g)
        bound = b.roofline_s
        # the default is not legal on a problem smaller than its block
        d = d or dataclasses.replace(b, bn=0, kb=0, eager_s=math.nan,
                                     graph_s=math.nan, graph_spread_s=0.0)
        beats = d.graph_s - b.graph_s > max(d.graph_spread_s,
                                            b.graph_spread_s)
        legal = d.bn > 0
        summary.append({
            "kernel": kernel, "n": n, "k": k, "update_itemsize": usize,
            "default": [d.bn, d.kb] if legal else None,
            "default_eager_ms": d.eager_s * 1e3 if legal else None,
            "default_graph_ms": d.graph_s * 1e3 if legal else None,
            "best": [b.bn, b.kb],
            "best_eager_ms": b.eager_s * 1e3, "best_graph_ms": b.graph_s * 1e3,
            "best_spread_ms": b.graph_spread_s * 1e3, "bound_ms": bound * 1e3,
            "beats_default": beats})
        log(f"  {kernel},{n},{k},{usize},{d.bn}/{d.kb},{d.eager_s * 1e3:.4f},"
            f"{d.graph_s * 1e3:.4f},{b.bn}/{b.kb},{b.eager_s * 1e3:.4f},"
            f"{b.graph_s * 1e3:.4f} ({b.graph_spread_s * 1e3:.4f}),"
            f"{bound * 1e3:.6f},{b.graph_s / bound:.3f},"
            f"{b.eager_s / bound:.3f},{beats}")
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "launch_shape_search.json").write_text(json.dumps(
        {"card": card, "overheads": over, "block_s": block_s,
         "rows": [dataclasses.asdict(r) for r in rows]}, indent=1))
    log(f"  wrote {out / 'launch_shape_search.json'} ({len(rows)} timed "
        f"shapes)")
    return {"overheads": over, "block_s": block_s, "rows": summary}


# --------------------------------------------------------------------------
# phase 14: the benchmarks on the card
# --------------------------------------------------------------------------
def benchmarks_on_card(torch, card: str) -> dict:
    """``repro_torch.benchmarks`` on the card, each timed on the host clock
    (synchronised) with its kernel launches counted: kernel_bench's model
    and measured rows with ``--check`` against ``kernel_baseline_h100.json``
    (the rows to chiprun_out/kernel_bench.json); real_ablation on
    qwen3-0.6b at full width and depth from its seeded weights, 3 parties,
    2 rounds of 48 sequences (the reference's default, example-100m,
    diverges from round 0 at its settings: ROADMAP Queue 3), which must
    fold through pair_fuse and in which JIT must bill no more
    container-seconds than eager-AO; periodicity at the reference's sizes.
    Returns each one's seconds, launches and results."""
    from repro_torch import configs
    from repro_torch.benchmarks import kernel_bench, periodicity, real_ablation
    from repro_torch.core import STRATEGIES
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg
    from repro_torch.models import model as M

    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    summary: dict = {"card": card}

    def counted(name, fn):
        free(torch)
        pair_fuse.launches = fused_agg.launches = quant_agg.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"pair_fuse": pair_fuse.launches,
                    "fused_agg": fused_agg.launches,
                    "quant_agg": quant_agg.launches}
        summary[name] = {"seconds": secs, "launches": launches,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  {name}: {secs:.3f} s (host clock, synchronised); kernel "
            f"launches {launches}; peak device memory "
            f"{summary[name]['peak_gib']:.2f} GiB")
        return result

    log(f"  kernel_bench (device time: CUDA-graph replays; bound: bytes "
        f"over 3.35 TB/s; {card}):")
    model, measured, sp = counted("kernel_bench", lambda: kernel_bench.main(
        ["--check", str(kernel_bench.BASELINE),
         "--out", str(out / "kernel_bench.json")]))
    summary["kernel_bench"].update(measured=measured, speedups=sp)

    cfg = configs.get_config("qwen3-0.6b")
    spec = real_ablation.build_spec(cfg, 3, 2, 8)
    log(f"  real_ablation: {cfg.name} at full width and depth "
        f"({M.n_params(cfg):,} params, {cfg.dtype}), seeded weights (seed "
        f"0), 3 heterogeneous parties, 2 FedProx rounds (mu "
        f"{spec.prox_mu}, lr {spec.lr}, batch 8) of 48 sequences, 32 eval "
        f"sequences; pricing t_pair 3 x {spec.model_bytes:,} B / 10 GB/s; "
        f"{len(STRATEGIES)} strategies replayed ({card}; virtual clock)")
    log(f"  {real_ablation.HEADER}")
    res, rows = counted("real_ablation", lambda: real_ablation.run(
        cfg, rounds=2, sequences=48, parties=3))
    jit, ao = (next(m for m in rows if m.strategy == s)
               for s in ("jit", "eager_ao"))
    log(f"  real_ablation: eval loss by round "
        f"{[r.global_loss for r in res.records]}; pricing t_pair "
        f"{res.runtime.t_pair0 * 1e3:.4f} ms; JIT {jit.container_seconds:.4f}"
        f" vs eager-AO {ao.container_seconds:.4f} container-s")
    summary["real_ablation"].update(rows={
        m.strategy: {"rounds": m.rounds_done, "mean_latency_s": m.mean_latency,
                     "p95_latency_s": m.p95_latency,
                     "container_seconds": m.container_seconds}
        for m in rows})
    if summary["real_ablation"]["launches"]["pair_fuse"] <= 0:
        raise AssertionError("real_ablation never launched pair_fuse")
    if not real_ablation.jit_within_always_on(rows):
        raise AssertionError(f"real_ablation: JIT billed "
                             f"{jit.container_seconds} > eager-AO "
                             f"{ao.container_seconds}")
    del res

    log(f"  periodicity ({card}):")
    per = counted("periodicity", lambda: periodicity.main([]))
    summary["periodicity"].update(per)
    log("  phase 14 summary: " + json.dumps(summary))
    return summary


# --------------------------------------------------------------------------
# phase 15: the sharding half on a one-rank NCCL mesh
# --------------------------------------------------------------------------
def moe_branch(torch, mesh, name: str, tol: float) -> dict:
    """The expert-parallel branch on the 1 x 1 mesh against ``moe_apply``
    on the same seeded layer (full width, bf16) and x: the output and the
    aux loss, ``==`` or within ``tol`` of the output's largest
    magnitude."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.spec import init_params

    cfg = configs.get_config(name)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = init_params(gen, moe.moe_specs(cfg))
    x = torch.randn(*MOE_X, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        y0, a0 = moe.moe_apply(cfg, p, x)
        t0 = time.perf_counter()
        y1, a1 = moe._moe_apply_shard_map(cfg, p, x, mesh, ("data",),
                                          "model")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gap = float((y1.float() - y0.float()).abs().max())
    scale = float(y0.float().abs().max())
    row = {"config": name, "experts": cfg.num_experts,
           "d_model": cfg.d_model, "x": list(x.shape),
           "sequence_parallel": cfg.sequence_parallel,
           "equal": bool(torch.equal(y1, y0)), "gap": gap, "scale": scale,
           "aux": [float(a1), float(a0)], "branch_s": wall}
    log(f"  {name} expert-parallel branch on 1 x 1 vs moe_apply: "
        f"{'==' if row['equal'] else 'not =='}, largest gap {gap:.3e} of "
        f"{scale:.3e} (tolerance {tol:.3e} of it); aux {float(a1):.6f} vs "
        f"{float(a0):.6f}; {wall * 1e3:.2f} ms (host clock, synchronised)")
    if not (y1.shape == y0.shape and gap <= tol * scale
            and abs(float(a1) - float(a0)) <= 1e-6 * abs(float(a0))
            and bool(torch.isfinite(y1).all())):
        raise AssertionError(f"{name}: the expert-parallel branch differs "
                             f"from moe_apply: {row}")
    del p, x, y0, y1
    return row


def train_profiles(torch) -> dict:
    """``launch.train.main`` on reduced qwen2-moe-a2.7b, 3 steps, with the
    baseline and the optimized profile: the optimized run must take the
    expert-parallel branch and give the baseline's losses, ``==``."""
    import contextlib
    import io

    from repro_torch.launch import steps, train
    from repro_torch.models import moe

    real_step, real_branch = steps.make_train_step, moe._moe_apply_shard_map
    out = {}
    for profile in ("baseline", "optimized"):
        losses, calls = [], []

        def make_step(cfg, optimizer=None):
            step = real_step(cfg, optimizer)

            def recorded(params, opt_state, batch):
                res = step(params, opt_state, batch)
                losses.append(float(res[2]["loss"]))
                return res

            return recorded

        def branch(*a):
            calls.append(1)
            return real_branch(*a)

        steps.make_train_step, moe._moe_apply_shard_map = make_step, branch
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                                 "--steps", "3", "--profile", profile])
        finally:
            steps.make_train_step = real_step
            moe._moe_apply_shard_map = real_branch
        out[profile] = {"rc": rc, "losses": losses, "branch_calls": len(calls)}
    log(f"  train.main --reduced qwen2-moe-a2.7b, 3 steps: {out}")
    base, opt = out["baseline"], out["optimized"]
    if not (base["rc"] == opt["rc"] == 0 and len(base["losses"]) == 3
            and opt["losses"] == base["losses"] and opt["branch_calls"] > 0
            and base["branch_calls"] == 0):
        raise AssertionError(f"train.main --profile optimized: {out}")
    return out


def sharding_half(torch, card: str) -> tuple:
    """Phase 15, with its summary line. Returns the dist_agg measurement
    (its fused_agg launches and error go into the kernels line)."""
    from repro_torch.benchmarks import dist_agg
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.pair_fuse import pair_fuse
    from repro_torch.kernels.quant_agg import quant_agg
    from repro_torch.launch.mesh import one_rank_mesh

    import torch.distributed as dist

    free(torch)
    with one_rank_mesh(torch.device("cuda")) as mesh:
        log(f"  mesh {mesh} ({dist.get_backend()}, world "
            f"{dist.get_world_size()})")
        rows = [moe_branch(torch, mesh, name, tol) for name, tol in MOE_BRANCH]
        free(torch)
        profiles = train_profiles(torch)
        free(torch)
        pair_fuse.launches = fused_agg.launches = quant_agg.launches = 0
        m = dist_agg.measure("qwen3-0.6b", k=8, mesh=mesh)
        others = pair_fuse.launches + quant_agg.launches
    free(torch)
    log(f"  dist_agg qwen3-0.6b K={m['k']} fp32, {m['ranks']} rank "
        f"({m['n_per_rank']:,} elements a rank): {m['ms']:.4f} ms (CUDA "
        f"events), bound {m['bound_ms']:.4f} ms by {m['bound_by']}, "
        f"{m['ratio']:.4f} x; plain {m['plain_ms']:.4f} ms, library "
        f"(torch.matmul) {m['library_ms']:.4f} ms; max_abs_err "
        f"{m['max_abs_err']:.3e}; collectives {m['collectives']}; "
        f"fused_agg launches in the fusion {m['launches']} ({card})")
    if m["launches"] < 1 or others:
        raise AssertionError(f"dist_agg's fusion launched fused_agg "
                             f"{m['launches']} times, the other kernels "
                             f"{others}")
    if m["ratio"] > KERNEL_LIMIT:
        raise AssertionError(f"dist_agg fusion: {m['ratio']:.4f} x its bound")
    log("  phase 15 summary: " + json.dumps(
        {"card": card, "moe_branch": rows, "train": profiles,
         "dist_agg": m}))
    return m


# phase 16: the production layout's collectives
# --------------------------------------------------------------------------
# (config, B, S, AdamW steps) trained through launch.train.run_on_mesh on a
# one-rank NCCL 1 x 1 mesh, DTensor parameters, against run_one_device
# (train.main's loop) from the same seed. On one rank every DTensor op is
# its local op, so the losses should be equal; MESH_LOSS_RTOL allows for
# a reduction whose order on the card varies from run to run
MESH_TRAIN = ("qwen3-0.6b", 8, 128, 3)
MESH_LOSS_RTOL = 1e-4
# the dry run of the production layout, in a subprocess: a layout-only
# process group cannot share a process with NCCL's
DRY_ARGS = ("--arch", "qwen3-0.6b", "--shape", "train_4k", "--mesh", "16x16")


def mesh_train(torch, device: str = "cuda", reduced: bool = False) -> dict:
    """``run_on_mesh`` on a one-rank 1 x 1 mesh (NCCL on the card) and
    ``run_one_device`` from the same seed: the losses, equal or within
    MESH_LOSS_RTOL. Then one step again with its collectives counted
    (``count=True``, the record's hook on every operator): the same first
    loss, and no collective on one rank."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.launch.train import run_on_mesh, run_one_device

    name, b, s, n = MESH_TRAIN
    cfg = configs.get_config(name)
    if reduced:
        cfg = cfg.reduced()
    shape = InputShape("phase16", s, b, "train")
    quiet = lambda line: None  # noqa: E731
    t0 = time.perf_counter()
    plain = run_one_device(cfg, shape, n, device, log=quiet)
    t_plain = time.perf_counter() - t0
    free(torch)
    with one_rank_mesh(torch.device(device)) as mesh:
        t0 = time.perf_counter()
        out = run_on_mesh(cfg, shape, mesh, steps=n, device=device, log=quiet)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        counted = run_on_mesh(cfg, shape, mesh, steps=1, device=device,
                              log=quiet, count=True)
        t_counted = time.perf_counter() - t0
    free(torch)
    losses = [r["loss"] for r in out]
    gap = max(abs(a - p) / abs(p) for a, p in zip(losses, plain))
    row = {"config": cfg.name, "batch": b, "seq": s, "steps": n,
           "mesh_losses": losses, "plain_losses": plain,
           "equal": losses == plain, "max_rel_gap": gap,
           "counted_loss": counted[0]["loss"],
           "collectives": counted[0]["collectives"],
           "mesh_s": t_mesh, "plain_s": t_plain, "counted_s": t_counted}
    log(f"  run_on_mesh {cfg.name} B {b} x {s}, {n} AdamW steps on a 1 x 1 "
        f"mesh, DTensor parameters: losses {losses} ({t_mesh:.1f} s); "
        f"run_one_device: {plain} ({t_plain:.1f} s); "
        f"{'==' if row['equal'] else 'not =='}, largest relative gap "
        f"{gap:.3e} (tolerance {MESH_LOSS_RTOL}); one step counted: loss "
        f"{row['counted_loss']}, collectives {row['collectives']} "
        f"({t_counted:.1f} s; host clock, initialisation included)")
    if not (len(losses) == n and all(math.isfinite(x) for x in losses)
            and gap <= MESH_LOSS_RTOL
            and abs(row["counted_loss"] - losses[0])
            <= MESH_LOSS_RTOL * abs(losses[0])
            and not any(row["collectives"].values())):
        raise AssertionError(f"run_on_mesh on one rank: {row}")
    return row


def dry_count(card: str) -> dict:
    """``launch.dryrun`` of qwen3-0.6b x train_4k on the 16 x 16 layout, in
    a subprocess (the layout-only group cannot share the process with
    NCCL's): its collective line and its time."""
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dry.json"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *DRY_ARGS, "--json", str(path)],
                           capture_output=True, text=True, env=env,
                           timeout=900)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"dryrun {' '.join(DRY_ARGS)} failed:\n"
                                 f"{r.stderr[-3000:]}")
        out = json.loads(path.read_text())
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("collectives(")), "")
    log(f"  dryrun {' '.join(DRY_ARGS)}: {line}; stepped in "
        f"{out['t_count_s']} s, {wall:.1f} s with the subprocess (host "
        f"clock; {card})")
    if not (out["ok"] and out["chips"] == 256 and out["mesh"] == "16x16"
            and out["collective_bytes_per_device"] > 0
            and all(out["collective_counts"][k] > 0
                    for k in ("all-gather", "all-reduce"))):
        raise AssertionError(f"dryrun on 16 x 16: {out}")
    return {k: out[k] for k in (
        "mesh", "chips", "collective_bytes_per_device", "collective_by_kind",
        "collective_counts", "collective_param_gathers", "counted_flops",
        "collective_term_s", "t_count_s")} | {"wall_s": wall}


def layout_phase(torch, card: str) -> None:
    """Phase 16, with its summary line."""
    free(torch)
    train = mesh_train(torch)
    dry = dry_count(card)
    log("  phase 16 summary: " + json.dumps(
        {"card": card, "mesh_train": train, "dry_count": dry}))


def kernel_limit(kernels: list) -> None:
    """Phase 3's times (device-bound launches at the main path's largest
    leaf) at most KERNEL_LIMIT x their bound."""
    for t in kernels:
        ratio = t["ms"] / t["bound_ms"]
        log(f"  {t['name']} at its main-path shape: {ratio:.4f} x its bound"
            f" (limit {KERNEL_LIMIT} x)")
        if ratio > KERNEL_LIMIT:
            raise AssertionError(f"{t['name']}: {ratio:.4f} x its bound")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port is not at {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    secs = build.build_all()
    log(f"built {sorted(build.SIGNATURES)} in {secs:.2f} s")
    for name, text in sorted(build.build_log.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} instantiations, {min(regs)}-{max(regs)} "
            f"registers/thread, {spills} bytes of spills")

    # 3. kernels against their plain versions, and their times
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("phase 3: kernels against their plain versions")
    # timed first: after the checks' 10 GB operands go back to the driver,
    # the next tens of milliseconds of launches run slow (PERF.md section 6)
    t_pf, t_fa = time_kernels(torch, gen)
    t_qa = time_quant_agg(torch, gen)
    err_pf = check_pair_fuse(torch, gen)
    table_sizes = check_pair_fuse_table(torch, gen)
    err_fa = check_fused_agg(torch, gen)
    err_qa = check_quant_agg(torch, gen)
    check_quantize(torch, gen)
    for name, t in (("pair_fuse", t_pf), ("fused_agg", t_fa)):
        log(f"  {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms")
    log(f"  quant_agg: {t_qa['ms']:.4f} ms (bound {t_qa['bound_ms']:.4f} ms "
        f"by {t_qa['bound_by']}), plain {t_qa['plain_ms']:.4f} ms, library "
        f"none: no single PyTorch call takes int8 rows with fp32 scales, so "
        f"library_ms is null")
    single_pair_line(t_pf)
    time_table_folds(torch, gen, table_sizes)
    torch.cuda.empty_cache()

    # 4. the main path
    log("phase 4: main path")
    res, main_launches = main_path(torch)
    p4 = local_steps(res)
    small_agreement(torch)

    # 5. the batch path
    log("phase 5: batch path")
    batch_launches = batch_path(torch, res)

    # 6. the quantised path
    log("phase 6: quantised path")
    quant_launches = quantized_path(torch, res)
    serve_quantized_full(torch)

    # 7. checkpoint
    log("phase 7: checkpoint round trip")
    checkpoint_round_trip(torch, res)

    # 8. the simulation vehicles priced on the card
    log(f"phase 8: the simulation vehicles priced on the card ({smi})")
    table, table_search = cost_table(torch, res, smi)
    fleets(table, res, smi)
    online_service(table, smi)
    del res, table

    # 9. the other families at full width
    log(f"phase 9: the other families at full width ({smi})")
    for name, layers in FAMILIES:
        res, _ = family_path(torch, name, layers)
        if res.runtime.cfg.num_experts:
            moe_extras(torch, res)
        del res
    # phase 4's small agreement for each family (qwen1.5-4b's reduced
    # config is qwen2.5-14b's)
    for name in ("qwen2.5-14b", "qwen2-moe-a2.7b"):
        small_agreement(torch, name)

    # 10. the examples
    log(f"phase 10: the examples on the card ({smi})")
    examples(torch)

    # 11. the launchers
    log(f"phase 11: the launchers on the card ({smi})")
    serve11, train11 = launchers(torch, smi)

    # 12. the SSM, RG-LRU hybrid, audio and VLM families
    log(f"phase 12: the SSM, hybrid, audio and VLM families ({smi})")
    serve12 = recurrent_families(torch, smi)

    # 13. the roofline of the launchers and the launch-shape search
    log("phase 13: the roofline of the launchers and the launch-shape "
        "search")
    log(smi)
    rows13 = roofline_rows(p4, serve11 + serve12, train11)
    flops13 = flops_on_card(torch, train11)
    search13 = launch_shape_search(torch, smi, table_search)
    kernel_limit([{"name": n, **t} for n, t in (
        ("pair_fuse", t_pf), ("fused_agg", t_fa), ("quant_agg", t_qa))])
    log("  phase 13 summary: " + json.dumps(
        {"card": smi, "roofline": rows13, "flops": flops13,
         "search": search13}))

    # 14. the benchmarks on the card
    log(f"phase 14: the benchmarks on the card ({smi})")
    benchmarks_on_card(torch, smi)

    # 15. the sharding half on a one-rank NCCL mesh
    log(f"phase 15: the sharding half on a one-rank NCCL mesh ({smi})")
    agg15 = sharding_half(torch, smi)

    # 16. the production layout: the --shape path on a one-rank mesh and
    # the dry count of the 16 x 16 layout
    log(f"phase 16: the production layout's collectives ({smi})")
    layout_phase(torch, smi)

    # 17. Nemotron-3-Nano's cut
    log(f"phase 17: {NEMOTRON}'s cut ({smi})")
    nemotron_phase(torch, smi)

    # 18. the record
    kernels = [
        {"name": "pair_fuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pair_fuse.cu",
         "replaces": "src/repro/kernels/pair_fuse.py:46",
         "launches": main_launches["pair_fuse"], "max_abs_err": err_pf,
         **t_pf},
        {"name": "fused_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
         "replaces": "src/repro/kernels/fused_agg.py:42",
         "launches": batch_launches + agg15["launches"],
         "max_abs_err": max(err_fa, agg15["max_abs_err"]), **t_fa},
        {"name": "quant_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quant_agg.cu",
         "replaces": "src/repro/kernels/quant_agg.py:37",
         "launches": quant_launches, "max_abs_err": err_qa, **t_qa},
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all (host "
        f"clock, the build included; {smi})")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
