"""Nemotron-3-Nano (Nemotron-H: Mamba-2, MoE and attention blocks) in the
port against the benchmark's plain float32 reference
(``bench/fedbench/reference/nemotron_h.py``), at a small size on seeded
weights: each block type, the whole model's logits and loss, one step's
gradients, the layer that holds a share of the experts, and the routing
counters.

Tolerances. In float32 the port and the reference compute the same
functions by different routes (the chunked SSD against a position-by-
position recurrence, the dispatch tables against a loop over the
experts, a remat'd backward), so they differ by float32 rounding: 2e-5
of the largest magnitude for one block, 1e-4 for the 13 layers of the
whole model (2e-5 to 4e-5 read over four seeds), 1e-2 of each leaf's
largest for one step's gradients (the SSM's per-head leaves, A_log,
dt_bias and D, sum many terms that cancel: up to 3.8e-3 over three
seeds, the other leaves under 3e-4). Running the port in bf16 instead
moves a block by about 1e-2, the logits by 0.4 to 1.1 (its rounding
flips routing choices) and the gradients by 2 to 4.5, which the same
tolerances refuse.

The weights: the program's initialiser, with the leaves it starts at a
constant (conv and correction biases, ``dt_bias``, the norms) redrawn, so
that a wrong path through them shows."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, tree_leaves, tree_map, tree_unflatten
from repro_torch.api import Platform
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.configs.nemotron_3_nano_30b_a3b import PATTERN
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import moe, ssm
from repro_torch.obs.trace import Tracer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))
from fedbench.reference import nemotron_h as ref  # noqa: E402

NAME = "nemotron-3-nano-30b-a3b"
TOL, MODEL_TOL, GRAD_TOL = 2e-5, 1e-4, 1e-2
#: the cut's 13 layers at a small width: 16 experts top-4, a share of 2
SMALL = dict(num_layers=13, d_model=64, head_dim=16, d_ff=32,
             shared_d_ff=64, vocab_size=128, num_experts=16,
             num_experts_per_tok=4, experts_held=2, expert_first=0)


def small(dtype="float32", **over):
    return configs.get_config(NAME).reduced(**{**SMALL, "dtype": dtype,
                                               **over})


def published(cfg):
    """The reference's configuration keys for the port's ``cfg``."""
    return {"hybrid_override_pattern": PATTERN,
            "mamba_num_heads": cfg.ssm_heads,
            "mamba_head_dim": cfg.ssm_head_dim, "n_groups": cfg.ssm_groups,
            "ssm_state_size": cfg.ssm_state,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "norm_topk_prob": True,
            "routed_scaling_factor": cfg.routed_scale,
            "norm_eps": cfg.norm_eps}


def weights(cfg, seed=0):
    """Seeded weights with the constant-initialised leaves redrawn."""
    gen = torch.Generator().manual_seed(seed)
    params = M.init(cfg, gen)

    def redraw(path, a):
        if path[-1] in ("conv_x_bias", "conv_B_bias", "conv_C_bias",
                        "e_score_correction_bias"):
            return (0.1 * torch.randn(a.shape, generator=gen)).to(a.dtype)
        if path[-1] in ("norm", "ln1", "final_norm"):
            return (1 + 0.1 * torch.randn(a.shape, generator=gen)).to(
                a.dtype)
        if path[-1] == "dt_bias":  # Mamba-2's: dt log-uniform in [1e-3, 0.1]
            dt = torch.empty(a.shape).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen).exp()
            return (dt + torch.log(-torch.expm1(-dt))).to(a.dtype)
        return a

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else redraw(path + (k,), v) for k, v in tree.items()}

    return walk(params)


def tokens(cfg, seed=1, b=2, s=32):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
            for k in ("tokens", "labels")}


def gap(got, want):
    """The largest difference over the largest magnitude of ``want``."""
    got, want = got.detach().to(torch.float32), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def layer(params, j):
    """Layer j's weights (the cut is one stage of one repeat)."""
    key = next(k for k in params["stage0"] if k.startswith(f"b{j}_"))
    return tree_map(lambda a: a[0], params["stage0"][key])


def block_input(cfg, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((2, 32, cfg.d_model), generator=gen)


def test_the_registered_model_has_the_published_size():
    cfg = configs.get_config(NAME)
    assert M.n_params(cfg) == 31_577_940_288
    assert "".join({"ssm": "M", "moe_only": "E", "attn_only": "*"}[b]
                   for b in cfg.block_types()) == PATTERN
    assert cfg.d_inner == 4096 and cfg.name not in configs.ARCH_IDS


def test_the_cut_has_its_size_and_leaves():
    cut = dataclasses.replace(configs.get_config(NAME), num_layers=13,
                              experts_held=16, vocab_size=16_384)
    specs = tree_leaves(M.param_specs(cut))
    assert M.n_params(cut) == 1_267_091_968 and len(specs) == 150
    experts = sum(math.prod(s.shape) for s in specs
                  if s.axes[1:2] == ("experts",))
    assert experts == 798_228_480


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_with_groups_matches_reference(dtype):
    cfg = small()
    assert cfg.ssm_groups == 2 and cfg.ssm_heads == 4
    p = layer(weights(cfg), 0)["ssm"]
    x = block_input(cfg)
    want = ref.mamba(published(cfg), tree_map(lambda a: a.float(), p), x)
    cast = tree_map(lambda a: a.to(getattr(torch, dtype)), p)
    got, _ = ssm.ssm_apply(small(dtype), cast, x.to(getattr(torch, dtype)))
    assert (gap(got, want) <= TOL) == (dtype == "float32"), gap(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_reference(dtype):
    cfg = small(experts_held=0)  # all 16 experts
    p = layer(weights(cfg), 1)["ffn"]
    x = block_input(cfg)
    want = ref.moe(published(cfg), tree_map(lambda a: a.float(), p), x, 0)
    cast = tree_map(lambda a: a.to(getattr(torch, dtype)), p)
    got, _ = moe.moe_apply(small(dtype, experts_held=0), cast,
                           x.to(getattr(torch, dtype)))
    assert (gap(got, want) <= TOL) == (dtype == "float32"), gap(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_without_rotary_matches_reference(dtype):
    cfg = small()
    assert not cfg.rotary
    p = layer(weights(cfg), 5)["attn"]
    x = block_input(cfg)
    want = ref.attention(published(cfg), tree_map(lambda a: a.float(), p), x)
    cast = tree_map(lambda a: a.to(getattr(torch, dtype)), p)
    got, _ = attn.self_attention(small(dtype), cast,
                                 x.to(getattr(torch, dtype)),
                                 torch.arange(32, dtype=torch.int32))
    assert (gap(got, want) <= TOL) == (dtype == "float32"), gap(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_reference(dtype):
    cfg = small()
    params, batch = weights(cfg), tokens(cfg)
    want = ref.forward(published(cfg), params, batch["tokens"])
    want_loss = ref.loss(published(cfg), params, batch["tokens"],
                         batch["labels"])
    low = small(dtype)
    cast = tree_map(lambda a: a.to(getattr(torch, dtype)), params)
    with torch.no_grad():
        got, _, _ = M.forward(low, cast, batch["tokens"])
        loss = M.loss_fn(low, cast, batch)[0]
    ok = gap(got, want) <= MODEL_TOL and abs(
        float(loss) - float(want_loss)) <= MODEL_TOL * float(want_loss)
    assert ok == (dtype == "float32"), (gap(got, want), float(loss),
                                        float(want_loss))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_sgd_step_gradients_match_reference(dtype):
    cfg = small()
    params, batch = weights(cfg), tokens(cfg)
    cast = tree_map(lambda a: a.to(getattr(torch, dtype)), params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(cast)]
    loss = M.loss_fn(small(dtype), tree_unflatten(cast, leaves), batch)[0]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    rleaves = [p.detach().clone().requires_grad_(True)
               for p in tree_leaves(params)]
    rloss = ref.loss(published(cfg), tree_unflatten(params, rleaves),
                     batch["tokens"], batch["labels"])
    want = torch.autograd.grad(rloss, rleaves, allow_unused=True)
    unreached, worst = 0, 0.0
    for g, w in zip(got, want, strict=True):
        if w is None:  # the correction bias chooses experts only
            assert g is None
            unreached += 1
            continue
        worst = max(worst, gap(g, w))
    assert unreached == 5  # one bias a MoE layer
    assert (worst <= GRAD_TOL) == (dtype == "float32"), worst


def test_the_shares_of_the_experts_sum_to_the_whole_layer():
    """Eight layers of two experts each, from the same router, add up to
    the whole layer of sixteen, the shared expert counted once."""
    cfg = small(experts_held=0)
    p = layer(weights(cfg), 1)["ffn"]
    x = block_input(cfg)
    whole = ref.moe(published(cfg), p, x, 0)
    shared = ref.moe(published(cfg), dict(p, w_up=p["w_up"][:0],
                                           w_down=p["w_down"][:0]), x, 0)
    total = -7 * shared
    for j in range(8):
        share = dataclasses.replace(cfg, expert_first=2 * j, experts_held=2)
        part = dict(p, w_up=p["w_up"][2 * j:2 * j + 2],
                    w_down=p["w_down"][2 * j:2 * j + 2])
        y, _ = moe.moe_apply(share, part, x)
        total = total + y
    assert gap(total, whole) <= TOL, gap(total, whole)


def test_routing_counters_read_the_reference_and_drop_nothing():
    cfg = small()
    params, batch = weights(cfg), tokens(cfg)
    tracer = Tracer(clock="wall")
    with torch.no_grad():
        M.forward(cfg, params, batch["tokens"], tracer=tracer)
    counts = {}
    ref.forward(published(cfg), params, batch["tokens"], counts=counts)
    read = {k: tracer.metrics.counter(f"moe.{k}").n
            for k in ("assignments", "held_assignments", "dropped")}
    assert read["dropped"] == 0
    assert read["assignments"] == counts["assignments"] == 5 * 2 * 32 * 4
    assert read["held_assignments"] == counts["held_assignments"] > 0


def test_a_capacity_below_every_position_drops_and_is_counted():
    """The counter sees drops where there are some: the same layer with
    the softmax models' capacity rule."""
    cfg = small(dropless=False, capacity_factor=0.25)
    tracer = Tracer(clock="wall")
    with torch.no_grad():
        M.forward(cfg, weights(cfg), tokens(cfg)["tokens"], tracer=tracer)
    assert tracer.metrics.counter("moe.dropped").n > 0


def test_prefill_and_decode_run_through_the_new_blocks():
    """Serving is not held to the reference here; the E and * blocks take
    their caches and a decode step after a prefill gives finite logits
    of the teacher-forced forward's shape."""
    cfg = small()
    params, batch = weights(cfg), tokens(cfg)
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, batch["tokens"][:, :16],
                                  capacity=32)
        step, cache = M.decode_step(cfg, params, cache,
                                    batch["tokens"][:, 16:17])
    assert step.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(step).all()) and int(cache["t"]) == 17


def test_platform_trains_the_small_model_and_leaves_the_bias():
    """``Platform().train``: 2 parties, 2 FedAvg rounds, every fold
    through the queue and the aggregator; the loss stays finite and the
    correction bias, which no gradient reaches, is the initial one."""
    cfg = small()
    init = weights(cfg)
    spec = FLJobSpec(job_id="nemotron", model_arch=cfg.name,
                     model_bytes=M.n_params(cfg) * 4,
                     aggregation_algorithm="fedavg", rounds=2, lr=0.05,
                     batch_size=8,
                     parties={f"p{i}": PartySpec(f"p{i}") for i in range(2)})
    res = Platform().train(cfg, spec, device="cpu", n_sequences=32,
                           eval_sequences=8, seed=0, initial_params=init)
    assert len(res.records) == 2
    assert all(math.isfinite(r.global_loss) for r in res.records)
    fused = res.runtime.global_params
    for key in fused["stage0"]:
        if key.endswith("_moe_only"):
            bias = fused["stage0"][key]["ffn"]["e_score_correction_bias"]
            assert torch.equal(
                bias, init["stage0"][key]["ffn"]["e_score_correction_bias"])
