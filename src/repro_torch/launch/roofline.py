"""Analytic roofline model per (architecture x input shape).

A copy of the reference's ``launch/roofline.py``: the same closed-form
FLOP and byte counts, in the same order, so ``step_counts`` and
``analytic_roofline`` give the reference's numbers ``==`` for the same
``HardwareSpec``. Only the imports differ, and the default card.

Why analytic: the architecture is fully known, so closed-form FLOP and
byte counts need no trace. The port's dry run (``launch/dryrun.py``)
records beside them the FLOPs ``torch.utils.flop_counter`` counts when the
step runs on "meta" tensors.

The copy keeps the reference's decode-context cap: ``_block_fwd_flops``
and the score traffic cap a decode's attended context at ``swa_window``
for every ``swa`` configuration and every decode shape, while
``decode_capacity`` gives ``decode_32k`` a cache of all 32,768 slots, so
the attention FLOPs of ``decode_32k`` are a quarter of what the step does
(ROADMAP, faults of the reference). A fix belongs to the reference first.

Hardware: one NVIDIA H100 SXM (``launch.mesh.H100``): 989 TFLOP/s bf16
dense, 3.35 TB/s HBM, NVLink at 25 GB/s a link each way. At one card the
collective term is 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch.mesh import H100, HardwareSpec

BF16 = 2
F32 = 4


def bandwidth_time_s(bytes_moved: float, hw: HardwareSpec = H100) -> float:
    """Bandwidth-roofline execution time for a memory-bound kernel: the
    HBM bytes it moves divided by the card's HBM bandwidth. The kernel
    launch-shape search (``repro_torch.kernels.autotune``) scores the CUDA
    fusion kernels with it: they never leave the memory roof."""
    return bytes_moved / hw.hbm_bw


def _avg_causal_ctx(seq: int, window: Optional[int]) -> float:
    """Average attended context length per query position."""
    if window is None or window >= seq:
        return (seq + 1) / 2.0
    # positions < window attend i+1; others attend window
    return (window * (window + 1) / 2.0 + (seq - window) * window) / seq


@dataclasses.dataclass
class Counts:
    fwd_flops: float = 0.0  # global forward FLOPs for the step
    param_bytes: float = 0.0  # all parameters, bf16
    act_bytes: float = 0.0  # activation traffic (fwd), bytes
    attn_score_bytes: float = 0.0  # score/probs traffic
    cache_bytes: float = 0.0  # KV/state cache size (decode/prefill)


def _block_fwd_flops(cfg: ModelConfig, bt: str, tokens: float, seq: int,
                     batch: float, kind: str) -> float:
    d = cfg.d_model
    f = 0.0
    if bt in ("attn", "lattn", "moe"):
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        f += 2 * tokens * d * (2 * h * hd + 2 * kv * hd)  # qkvo projections
        if kind == "decode":
            cap = min(seq, cfg.swa_window) if cfg.long_context == "swa" else seq
            if bt == "lattn":
                cap = min(cap, cfg.sliding_window or cap)
            ctx = cap
        else:
            ctx = _avg_causal_ctx(seq, cfg.sliding_window if bt == "lattn" else None)
        f += 2 * tokens * ctx * h * hd * 2  # qk^T and pv
        if bt == "moe":
            e, k = cfg.num_experts, cfg.num_experts_per_tok
            pad = cfg.capacity_factor
            f += 2 * tokens * d * e  # router
            f += 2 * (tokens * k * pad) * 3 * d * cfg.d_ff  # routed experts
            f += 2 * tokens * 3 * d * cfg.d_ff * cfg.num_shared_experts
        else:
            f += 2 * tokens * 3 * d * cfg.d_ff  # swiglu mlp
    elif bt == "xattn":
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        p = cfg.num_image_tokens
        f += 2 * tokens * d * 2 * h * hd  # q, o
        f += 2 * batch * p * d * 2 * kv * hd  # k, v over image tokens
        f += 2 * tokens * p * h * hd * 2  # scores + out
        f += 2 * tokens * 3 * d * cfg.d_ff
    elif bt == "rglru":
        r = cfg.rnn_width
        f += 2 * tokens * d * r * 2 + 2 * tokens * r * d  # w_y, w_x, w_out
        f += 2 * tokens * r * r * 2  # w_a, w_i gates
        f += 2 * tokens * r * cfg.conv_kernel  # conv
        f += tokens * r * 8  # scan elementwise
        f += 2 * tokens * 3 * d * cfg.d_ff
    elif bt == "ssm":
        din, n, hh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        pdim = cfg.ssm_head_dim
        f += 2 * tokens * d * (2 * din + 2 * n + hh)  # in projections
        f += 2 * tokens * din * d  # out projection
        f += 2 * tokens * cfg.conv_kernel * (din + 2 * n)  # convs
        if kind == "decode":
            f += tokens * hh * pdim * n * 4  # state update + readout
        else:
            q = min(cfg.ssm_chunk, seq)
            f += 2 * tokens * q * n  # intra-chunk scores C.B^T
            f += 2 * tokens * q * hh * pdim  # intra-chunk apply
            f += 2 * tokens * n * hh * pdim * 2  # chunk states + inter read
    else:
        raise ValueError(bt)
    return f


def step_counts(cfg: ModelConfig, shape: InputShape) -> Counts:
    from repro_torch.models import model as M

    kind = shape.kind
    b = shape.global_batch
    seq = shape.seq_len
    tokens = float(b * (seq if kind != "decode" else 1))
    c = Counts()
    c.param_bytes = M.n_params(cfg) * BF16

    # head (+ codebooks)
    heads = cfg.num_codebooks or 1
    c.fwd_flops += 2 * tokens * cfg.d_model * cfg.vocab_size * heads
    for bt in cfg.block_types():
        c.fwd_flops += _block_fwd_flops(cfg, bt, tokens, seq, b, kind)

    # activation traffic: ~8 major (B,S,d)-sized reads/writes per block
    c.act_bytes = len(cfg.block_types()) * 8 * tokens * cfg.d_model * BF16
    # attention score traffic (fp32 write+read of scores and probs)
    h = cfg.num_heads
    for bt in cfg.block_types():
        if bt in ("attn", "lattn", "moe"):
            if kind == "decode":
                ctx = min(seq, cfg.swa_window) if cfg.long_context == "swa" else seq
                if bt == "lattn":
                    ctx = min(ctx, cfg.sliding_window or ctx)
            else:
                ctx = _avg_causal_ctx(seq, cfg.sliding_window if bt == "lattn" else None)
            c.attn_score_bytes += tokens * ctx * h * (F32 + BF16) * 2

    # decode caches
    if kind in ("decode", "prefill"):
        from repro_torch.launch.steps import decode_capacity

        cap = decode_capacity(cfg, shape) if kind == "decode" else seq
        kvb = 0.0
        for bt in cfg.block_types():
            if bt in ("attn", "moe"):
                kvb += 2 * b * cap * cfg.num_kv_heads * cfg.head_dim * BF16
            elif bt == "lattn":
                w = min(cap, cfg.sliding_window or cap)
                kvb += 2 * b * w * cfg.num_kv_heads * cfg.head_dim * BF16
            elif bt == "xattn":
                kvb += 2 * b * cfg.num_image_tokens * cfg.num_kv_heads * cfg.head_dim * BF16
            elif bt == "ssm":
                kvb += b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * F32
            elif bt == "rglru":
                kvb += b * cfg.rnn_width * F32
        c.cache_bytes = kvb
    return c


@dataclasses.dataclass
class Roofline:
    flops: float  # global FLOPs per step
    hbm_bytes: float  # global HBM traffic per step
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float


def analytic_roofline(
    cfg: ModelConfig,
    shape: InputShape,
    chips: int,
    collective_bytes_per_device: float,
    hw: HardwareSpec = H100,
    ici_links: int = 2,
) -> Roofline:
    from repro_torch.models import model as M

    c = step_counts(cfg, shape)
    kind = shape.kind
    if kind == "train":
        flops = 3.0 * c.fwd_flops  # fwd + 2x bwd
        if cfg.remat == "full":
            flops += c.fwd_flops  # recompute
        # params: grads (w+r, f32) + adam m/v (r+w each, f32) + weights r/w
        p_elems = c.param_bytes / BF16
        hbm = (
            3 * c.param_bytes  # fwd read + bwd read + write
            + p_elems * (2 * F32)  # grad write+read
            + p_elems * (4 * F32)  # m, v read+write
            + (2 if cfg.remat == "full" else 1) * c.act_bytes
            + c.attn_score_bytes * (3 if cfg.remat == "full" else 2)
        )
    elif kind == "prefill":
        flops = c.fwd_flops
        hbm = c.param_bytes + c.act_bytes + c.attn_score_bytes + c.cache_bytes
    else:  # decode
        flops = c.fwd_flops
        hbm = c.param_bytes + c.act_bytes + c.attn_score_bytes + 2 * c.cache_bytes
    # MoE decode reads every expert's weights even at tiny batch; param_bytes
    # already counts all experts once, which matches the implementation.

    compute_s = flops / (chips * hw.peak_flops_bf16)
    memory_s = hbm / (chips * hw.hbm_bw)
    coll_s = collective_bytes_per_device / (ici_links * hw.ici_link_bw)

    n_active = M.n_active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if kind == "train" else 1)
    if kind == "train":
        model_flops = 6.0 * n_active * tokens
    elif kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * tokens

    terms = [("compute", compute_s), ("memory", memory_s),
             ("collective", coll_s)]
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=max(terms, key=lambda kv: kv[1])[0],
        model_flops=model_flops,
        useful_ratio=model_flops / flops if flops else 0.0,
    )
