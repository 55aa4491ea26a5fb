"""Mixture-of-Experts FFN: grouped gather/scatter dispatch (GShard-style
capacity, but without the quadratic one-hot dispatch einsum).

Routing is computed per sequence (group = batch element), so the gather and
the combine stay within the sequence axis. Dispatch costs O(tokens·E) for
the rank bookkeeping plus pure-bandwidth gathers; no FLOPs grow with
E·capacity·d_model.

The reference builds its tables with ``.at[...].max`` / ``.at[...].add``;
here ``scatter_reduce_(..., "amax")`` and ``scatter_add`` write the same
entries: every kept (token, choice) owns one slot, and a dropped one writes
token 0 and gate 0 to its expert's last slot, which changes nothing there.
Top-k ties break toward the lower expert index, as ``jax.lax.top_k`` does
(a stable descending sort).

The combine is a gather where the reference scatter-adds the slots back
onto their tokens (``_scatter_combine``): each token reads its kept slots
and adds them one by one in the order of their expert index, which is the
order in which the reference's scatter adds them. So a bf16 sum rounds as
the reference's does, and on the card no atomics make the order vary from
run to run. Empty slots, which the reference adds to token 0 times a zero
gate, are not read. The dispatch gather's gradient is the same combine
(``_GatherTokens``), so a training step is deterministic too.

The reference's ``shard_map`` branch (experts over a mesh's model axis) is
not ported: it needs a device mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs
from repro_torch.models.spec import TensorSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s: Dict[str, TensorSpec] = {
        "router": TensorSpec((d, e), ("d_model", None), scale=0.5),
        "w_gate": TensorSpec((e, d, f), ("experts", "d_model", "d_ff")),
        "w_up": TensorSpec((e, d, f), ("experts", "d_model", "d_ff")),
        "w_down": TensorSpec((e, f, d), ("experts", "d_ff", "d_model")),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(d, f * cfg.num_shared_experts)
    return s


def capacity(cfg: ModelConfig, seq: int) -> int:
    c = math.ceil(seq * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor)
    return max(4 * math.ceil(c / 4), 4)


def _route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """Router probs + normalised top-k gates. x: (B,S,d)."""
    logits = torch.einsum("bsd,de->bse", x, router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (B,S,E)
    k = cfg.num_experts_per_tok
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]  # (B,S,k)
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _slots(idx, e_rows: int, c: int):
    """(slot, keep), each (B,S,k): the flat (expert, rank) slot of every
    top-k assignment, rank being its arrival order within its expert, and
    whether that rank is within capacity. A dropped assignment's slot is
    its expert's last one."""
    b, s, k = idx.shape
    flat = F.one_hot(idx, e_rows).reshape(b, s * k, e_rows)
    rank_flat = torch.cumsum(flat, dim=1) - flat  # arrivals before me
    rank = torch.gather(rank_flat.reshape(b, s, k, e_rows), -1,
                        idx[..., None])[..., 0]  # (B,S,k)
    keep = rank < c
    return idx * c + torch.where(keep, rank, c - 1), keep


def _dispatch_tables(gate, idx, e_rows: int, c: int, dtype):
    """Token/gate lookup tables (B, e_rows, C) from top-k assignments;
    entries past capacity are dropped (gate 0). The token table is int64
    (torch's gather takes int64 indices). Also returns ``_slots``'s (slot,
    keep), which the gather and the combine take."""
    b, s, k = idx.shape
    slot, keep = _slots(idx, e_rows, c)
    flat = slot.reshape(b, s * k)
    tok = torch.arange(s, device=idx.device)[None, :, None].expand(b, s, k)
    table = torch.zeros((b, e_rows * c), dtype=torch.int64,
                        device=idx.device).scatter_reduce_(
        1, flat, torch.where(keep, tok, 0).reshape(b, s * k), "amax")
    gate_kept = torch.where(keep, gate, 0.0).to(dtype).reshape(b, s * k)
    gate_table = torch.zeros((b, e_rows * c), dtype=dtype,
                             device=idx.device).scatter_add(1, flat, gate_kept)
    return (table.reshape(b, e_rows, c), gate_table.reshape(b, e_rows, c),
            slot, keep)


def _expert_ffn(xg, wg, wu, wd, gate_table):
    """(B,E,C,d) tokens through per-expert SwiGLU, gate-weighted."""
    g = torch.einsum("becd,edf->becf", xg, wg)
    u = torch.einsum("becd,edf->becf", xg, wu)
    h = F.silu(g.to(torch.float32)).to(xg.dtype) * u
    out = torch.einsum("becf,efd->becd", h, wd)
    return out * gate_table[..., None]


class _GatherTokens(torch.autograd.Function):
    """The dispatch gather, whose gradient is the combine of the slots'
    gradients: each token sums the gradients of its kept slots in
    ascending expert order. ``torch.gather``'s own backward scatter-adds
    them with atomics on the card, in an order that varies from run to
    run. Empty slots, which gather token 0, get a zero gradient through
    their zero gate, so leaving them out changes nothing."""

    @staticmethod
    def forward(ctx, x, table, slot, keep):
        b, s, d = x.shape
        _, e, c = table.shape
        ctx.save_for_backward(slot, keep)
        xg = torch.gather(x, 1,
                          table.reshape(b, e * c, 1).expand(b, e * c, d))
        return xg.reshape(b, e, c, d)

    @staticmethod
    def backward(ctx, grad):
        slot, keep = ctx.saved_tensors
        return _combine(grad, slot, keep), None, None, None


def _gather_tokens(x, table, slot, keep):
    """x: (B,S,d); table: (B,E,C) -> (B,E,C,d) batched gather; slot and
    keep (from ``_slots``) give its gradient a fixed order."""
    return _GatherTokens.apply(x, table, slot, keep)


def _combine(out, slot, keep):
    """out: (B,E,C,d) gated expert outputs; slot, keep: (B,S,k) from
    ``_slots`` -> (B,S,d): each token's kept slots summed one at a time in
    ascending expert order (a slot orders as its expert)."""
    b, e, c, d = out.shape
    s, k = slot.shape[1:]
    slot, order = torch.sort(slot, dim=-1)
    keep = torch.gather(keep, -1, order)
    parts = torch.gather(out.reshape(b, e * c, d), 1,
                         slot.reshape(b, s * k, 1).expand(b, s * k, d))
    parts = torch.where(keep.reshape(b, s * k, 1), parts, 0.0)
    parts = parts.reshape(b, s, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


def _aux_loss(probs, idx, e: int) -> torch.Tensor:
    # fraction of tokens whose top-1 is e
    frac = torch.mean(F.one_hot(idx[..., 0], e).to(torch.float32), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    return e * torch.sum(frac * mean_prob)


def moe_apply(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    e = cfg.num_experts
    c = capacity(cfg, s)
    probs, gate, idx = _route(cfg, p["router"], x)
    table, gate_table, slot, keep = _dispatch_tables(gate, idx, e, c, x.dtype)
    xg = _gather_tokens(x, table, slot, keep)
    out = _expert_ffn(xg, p["w_gate"], p["w_up"], p["w_down"], gate_table)
    y = _combine(out, slot, keep)
    if cfg.num_shared_experts:
        y = y + mlp_apply(p["shared"], x)
    return y, _aux_loss(probs, idx, e)
