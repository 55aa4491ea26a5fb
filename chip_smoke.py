#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order (any failure ends the run
with a non-zero exit; no phase catches its own error):

 1. the card's name and power limit (nvidia-smi);
 2. build the hand-written CUDA kernels from src/repro_torch/kernels/csrc;
 3. hold each kernel against its plain PyTorch version on the card, at the
    main path's shapes and a ragged one, and time both, the kernel's bound
    and one PyTorch call computing the same function;
 4. the main path: ``Platform().train`` of qwen3-0.6b at full width (bf16),
    3 parties, 2 FedAvg rounds; the streaming fold must go through the
    pair_fuse kernel. Then the same path at a small size on the card and on
    the CPU from the same weights, which must agree;
 5. the batch path: ``FedAvg().fuse`` of the last round's real updates
    through the fused_agg kernel equals the streaming fold;
 6. one JSON line with every kernel's numbers, then the result line.

It imports nothing of JAX or of the JAX package, and needs one card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
MAIN_N = 151_936 * 1024  # qwen3-0.6b's largest leaf (embed, lm_head)
RAGGED_N = 1_000_003
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
                log(f"  pair_fuse {op:4s} {str(ta)[6:]}+{str(tb)[6:]} "
                    f"N={n}: max_abs_err={e:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"pair_fuse {op} disagrees: {e}")
                worst = max(worst, e)
                del got, want, err
            del a, b
    torch.cuda.synchronize()
    return worst


def check_fused_agg(torch, gen):
    """K = 3 and K = 17 (above the TPU kernel's 8-row tile), fp32 and bf16,
    main-path and ragged N. Tolerance: the kernel and the plain version
    (a cuBLAS product in full fp32) sum K terms in other orders, so they
    may differ by K fp32 roundings of sum_k |w_k u_kn|, and a bf16 output by
    one more bf16 ulp, 2**-7, of the same scale."""
    from repro_torch.kernels.fused_agg import fused_agg
    from repro_torch.kernels.ref import fused_agg_ref

    worst = 0.0
    for n in (MAIN_N, RAGGED_N):
        for k in (3, 17):
            for dt in (torch.float32, torch.bfloat16):
                u = torch.randn(k, n, generator=gen, device="cuda").to(dt)
                w = torch.rand(k, generator=gen, device="cuda")
                w = w / w.sum()
                got = fused_agg(u, w)
                want = fused_agg_ref(u, w)
                if got.dtype != dt or got.shape != (n,):
                    raise AssertionError(f"fused_agg: {got.dtype} "
                                         f"{tuple(got.shape)}")
                scale = torch.einsum("k,kn->n", w, u.float().abs())
                tol = k * 2.0 ** -23 + (2.0 ** -7 if dt == torch.bfloat16
                                        else 0.0)
                err = (got.float() - want.float()).abs()
                ok = bool((err <= tol * scale).all())
                e = float(err.max())
                log(f"  fused_agg K={k:2d} {str(dt)[6:]} N={n}: "
                    f"max_abs_err={e:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_agg disagrees: {e}")
                worst = max(worst, e)
                del u, got, want, scale, err
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
    for rec in res.records:
        if not (rec.global_loss == rec.global_loss and rec.global_loss < 1e9):
            raise AssertionError(f"round {rec.round_idx} loss not finite")
    specs = tree_leaves(M.param_specs(cfg))
    for s, p in zip(specs, tree_leaves(rt.global_params), strict=True):
        if tuple(p.shape) != s.shape or p.dtype != torch.bfloat16:
            raise AssertionError(f"fused leaf {tuple(p.shape)} {p.dtype}")
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("fused parameters not finite")
    del init
    return res, launches


def small_agreement(torch):
    """The same path at a small size (2 layers, d_model 64, vocab 128, fp32)
    on the card and on the CPU from the same weights. Tolerance: rtol 1e-4,
    atol 1e-5 on fused parameters and eval loss (fp32 products summed in
    other orders over two rounds of local SGD)."""
    from repro_torch import configs, tree_leaves
    from repro_torch.api import Platform
    from repro_torch.core.jobspec import FLJobSpec, PartySpec
    from repro_torch.models import model as M

    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    init = M.init(cfg, torch.Generator().manual_seed(SEED))
    out = {}
    for dev in ("cuda", "cpu"):
        job = FLJobSpec(
            job_id="small", model_arch=cfg.name,
            model_bytes=M.n_params(cfg) * 4, rounds=2, lr=0.05, batch_size=8,
            parties={f"p{i}": PartySpec(f"p{i}") for i in range(3)})
        res = Platform().train(cfg, job, device=dev, initial_params=init,
                               n_sequences=48, eval_sequences=16, seed=SEED)
        out[dev] = res
    worst = 0.0
    for rc, rp in zip(out["cuda"].records, out["cpu"].records, strict=True):
        if abs(rc.global_loss - rp.global_loss) > 1e-5 + 1e-4 * abs(rp.global_loss):
            raise AssertionError(f"small run: loss {rc.global_loss} vs "
                                 f"{rp.global_loss}")
    for a, b in zip(tree_leaves(out["cuda"].runtime.global_params),
                    tree_leaves(out["cpu"].runtime.global_params), strict=True):
        a = a.cpu()
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
            raise AssertionError("small run: fused parameters disagree")
        worst = max(worst, float((a - b).abs().max()))
    log(f"  small run card vs CPU: losses "
        f"{[round(r.global_loss, 6) for r in out['cuda'].records]} vs "
        f"{[round(r.global_loss, 6) for r in out['cpu'].records]}, "
        f"max |fused param diff|={worst:.3e} ok")


# --------------------------------------------------------------------------
# phase 5: batch path equals streaming
# --------------------------------------------------------------------------
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

    rt = res.runtime
    last = rt.records[-1].round_idx
    topic = rt.queue.topic(f"updates/{rt.spec.job_id}")
    msgs = [m.value for m in topic.poll("batch-check")
            if m.value["round"] == last]
    updates = [m["update"] for m in msgs]
    n_ex = [m["n_examples"] for m in msgs]
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


def main() -> int:
    import torch

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
    err_pf = check_pair_fuse(torch, gen)
    err_fa = check_fused_agg(torch, gen)
    t_pf, t_fa = time_kernels(torch, gen)
    for name, t in (("pair_fuse", t_pf), ("fused_agg", t_fa)):
        log(f"  {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms")
    torch.cuda.empty_cache()

    # 4. the main path
    log("phase 4: main path")
    res, main_launches = main_path(torch)
    small_agreement(torch)

    # 5. the batch path
    log("phase 5: batch path")
    batch_launches = batch_path(torch, res)

    # 6. the record
    kernels = [
        {"name": "pair_fuse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pair_fuse.cu",
         "replaces": "src/repro/kernels/pair_fuse.py:46",
         "launches": main_launches["pair_fuse"], "max_abs_err": err_pf,
         **t_pf},
        {"name": "fused_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
         "replaces": "src/repro/kernels/fused_agg.py:42",
         "launches": batch_launches, "max_abs_err": err_fa, **t_fa},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
