"""A plain reference of Nemotron-H's forward pass and loss
(NVIDIA-Nemotron-3-Nano-30B-A3B: huggingface.co/nvidia/NVIDIA-Nemotron-3-
Nano-30B-A3B-BF16, ``modeling_nemotron_h.py``), in float32 ``torch``
operations alone, TF32 off, with no kernel, cache or capacity.

Each block is x + mixer(RMSNorm(x)), the mixer chosen by the letter of
``hybrid_override_pattern``; then a final RMSNorm and the LM head.

* M, Mamba-2: z, x, B, C and dt projected from the input; a depthwise
  causal convolution with bias over x, B and C, then SiLU; dt =
  softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence run
  position by position (not the chunked form), head h reading B/C group
  h // (heads / groups); y + D x; y silu(z) normalised over each of the
  groups' slices of d_inner and scaled; the output projection.
* E, MoE: fp32 router logits and their sigmoids; the top-k experts chosen
  on the sigmoids plus ``e_score_correction_bias``, gated by the chosen
  sigmoids over their sum, times ``routed_scaling_factor``; each expert
  w_down(relu(w_up x)^2) over the tokens routed to it, every one of them
  (dropless); plus the relu^2 shared expert.
* \\*, attention: grouped-query causal attention without rotary
  embeddings, no bias.

Departures from the published model, each the configuration's own:

* the MoE layer holds experts ``expert_first`` .. ``expert_first + n - 1``
  of the router's experts (n from the weights' first dim), the share of
  one card of an expert-parallel deployment: tokens routed to other
  experts get nothing from them here, and the shared expert is whole;
* the vocabulary is whatever the weights hold (a card's slice of it);
* the correction bias is a fixed input: the published training moves it
  by its aux-loss-free rule, which is left out;
* everything runs in float32 (published: bf16 weights and activations).

The weights are a nested dict keyed as the benchmark's configuration file
lists them (``stage<i>`` / ``b<j>_<type>``, each leaf stacked over the
repeats of the stage's pattern); it imports nothing of the program."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F

F32 = torch.float32
BLOCK = {"ssm": "M", "moe_only": "E", "attn_only": "*"}


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 matrix products in float32: TF32 off while inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def layers(params: Dict) -> List[tuple]:
    """[(letter, that layer's weights in float32)] in the model's order:
    stage by stage, each stage's pattern repeated over its leaves' first
    dim."""
    out = []
    for st in sorted((k for k in params if k.startswith("stage")),
                     key=lambda k: int(k[5:])):
        blocks = sorted(params[st], key=lambda k: int(k[1:k.index("_")]))
        reps = _first_leaf(params[st][blocks[0]]).shape[0]
        for r in range(reps):
            for key in blocks:
                letter = BLOCK[key[key.index("_") + 1:]]
                out.append((letter, _slice(params[st][key], r)))
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _slice(tree, r):
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r].to(F32)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _conv(x, w, b):
    """Depthwise causal convolution: x (B, S, C), w (K, C), b (C,)."""
    k, s = w.shape[0], x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), b, padding=k - 1,
                 groups=x.shape[2])
    return y[..., :s].transpose(1, 2)


def mamba(cfg: Dict, p: Dict, h: torch.Tensor) -> torch.Tensor:
    bsz, s, _ = h.shape
    nh, hd = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n = cfg["n_groups"], cfg["ssm_state_size"]
    z = h @ p["w_z"]
    x = F.silu(_conv(h @ p["w_x"], p["conv_x"], p["conv_x_bias"]))
    bm = F.silu(_conv(h @ p["w_B"], p["conv_B"], p["conv_B_bias"]))
    cm = F.silu(_conv(h @ p["w_C"], p["conv_C"], p["conv_C_bias"]))
    dt = F.softplus(h @ p["w_dt"] + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["A_log"])  # (H,)
    x = x.reshape(bsz, s, nh, hd)
    bm = bm.reshape(bsz, s, g, n).repeat_interleave(nh // g, dim=2)
    cm = cm.reshape(bsz, s, g, n).repeat_interleave(nh // g, dim=2)
    state = torch.zeros(bsz, nh, hd, n, dtype=F32, device=h.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, :, None, None]
        state = decay * state + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                                 * bm[:, t, :, None, :])
        ys.append((state * cm[:, t, :, None, :]).sum(-1)
                  + p["D"][None, :, None] * x[:, t])
    y = torch.stack(ys, dim=1).reshape(bsz, s, nh * hd) * F.silu(z)
    din = nh * hd
    y = rms_norm(y.reshape(bsz, s, g, din // g),
                 p["norm"].reshape(g, din // g), cfg["norm_eps"])
    return y.reshape(bsz, s, din) @ p["w_out"]


def moe(cfg: Dict, p: Dict, h: torch.Tensor, expert_first: int,
        counts: Dict = None) -> torch.Tensor:
    """The MoE layer's part from experts ``expert_first`` .. (as many as
    the weights hold), plus the shared expert. ``counts``, if given, gets
    ``assignments`` and ``held_assignments`` added."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(h @ p["router"])  # (B, S, E)
    idx = torch.topk(scores + p["e_score_correction_bias"], k, dim=-1).indices
    gate = torch.gather(scores, -1, idx)
    if cfg["norm_topk_prob"]:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    gate = gate * cfg["routed_scaling_factor"]
    flat, y = h.reshape(-1, h.shape[-1]), torch.zeros_like(h).reshape(
        -1, h.shape[-1])
    idx, gate = idx.reshape(-1, k), gate.reshape(-1, k)
    held = p["w_up"].shape[0]
    for j in range(held):
        tok, slot = torch.nonzero(idx == expert_first + j, as_tuple=True)
        out = F.relu(flat[tok] @ p["w_up"][j]).pow(2) @ p["w_down"][j]
        y.index_add_(0, tok, out * gate[tok, slot, None])
    if counts is not None:
        counts["assignments"] = counts.get("assignments", 0) + idx.numel()
        counts["held_assignments"] = counts.get("held_assignments", 0) + int(
            ((idx >= expert_first) & (idx < expert_first + held)).sum())
    shared = F.relu(h @ p["shared"]["w_up"]).pow(2) @ p["shared"]["w_down"]
    return y.reshape(h.shape) + shared


def attention(cfg: Dict, p: Dict, h: torch.Tensor) -> torch.Tensor:
    s = h.shape[1]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q = torch.einsum("bsd,dhk->bhsk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", h, p["wk"]).repeat_interleave(
        nq // nkv, dim=1)
    v = torch.einsum("bsd,dhk->bhsk", h, p["wv"]).repeat_interleave(
        nq // nkv, dim=1)
    att = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(att.masked_fill(~causal, -math.inf), dim=-1)
    return torch.einsum("bhsk,hkd->bsd", att @ v, p["wo"])


def forward(cfg: Dict, params: Dict, tokens: torch.Tensor,
            expert_first: int = 0, counts: Dict = None) -> torch.Tensor:
    """float32 logits (B, S, V) of ``tokens`` (B, S). ``cfg`` holds the
    published configuration's keys (``hybrid_override_pattern``,
    ``mamba_num_heads``, ``n_groups``, ...); the model has as many layers
    as the weights list, which must follow the pattern."""
    with no_tf32():
        x = params["embed"].to(F32)[tokens]
        order = layers(params)
        if "".join(c for c, _ in order) != \
                cfg["hybrid_override_pattern"][:len(order)]:
            raise ValueError("the weights' layers do not follow the pattern")
        eps = cfg["norm_eps"]
        for letter, p in order:
            h = rms_norm(x, p["ln1"], eps)
            if letter == "M":
                x = x + mamba(cfg, p["ssm"], h)
            elif letter == "E":
                x = x + moe(cfg, p["ffn"], h, expert_first, counts)
            else:
                x = x + attention(cfg, p["attn"], h)
        x = rms_norm(x, params["final_norm"].to(F32), eps)
        return x @ params["lm_head"].to(F32)


def loss(cfg: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, expert_first: int = 0) -> torch.Tensor:
    """The mean next-token cross-entropy of ``labels`` under the logits."""
    logits = forward(cfg, params, tokens, expert_first)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
