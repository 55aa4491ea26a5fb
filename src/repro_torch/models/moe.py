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

Under the optimized profile with a mesh installed, ``moe_apply`` takes
the expert-parallel branch, ``_moe_apply_shard_map``: the rank's part of
the reference's ``shard_map`` (experts over the mesh's model axis, batch
over its data axes), with ``torch.distributed.nn.functional``'s
collectives on the mesh's groups.

Nemotron-H's layer (port-only fields of the config): a sigmoid router
whose top-k is chosen on the scores plus ``e_score_correction_bias`` (a
leaf no gradient reaches), gates normalised over the chosen scores and
scaled by ``routed_scale``; relu² experts and shared expert; a dispatch
with a capacity of every position (``dropless``); and a layer that holds
a share of the experts (``expert_first``, ``experts_held``). That layer
routes over all ``num_experts`` and computes its own experts' part of the
result only, as one rank of the expert-parallel branch does, without the
exchange; the shared expert is computed whole. With a ``Tracer`` the
layer counts its top-k choices (``moe.assignments``), those that fell on
its experts (``moe.held_assignments``) and those the capacity dropped
(``moe.dropped``) in ``Tracer.metrics``; a count reads the device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (mlp_apply, mlp_specs, relu2,
                                       relu2_mlp_apply, relu2_mlp_specs)
from repro_torch.models.sharding_ctx import (constrain, contract,
                                             head_local, is_dtensor,
                                             mesh_sizes, moe_shard_map_ctx)
from repro_torch.models.spec import TensorSpec
from repro_torch.obs.trace import NULL_TRACER


def moe_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    el = cfg.n_experts_held
    if not 0 <= cfg.expert_first <= e - el:
        raise ValueError(f"experts {cfg.expert_first}..{cfg.expert_first + el}"
                         f" are not among the {e}")
    s: Dict[str, TensorSpec] = {
        "router": TensorSpec((d, e), ("d_model", None), scale=0.5),
        "w_up": TensorSpec((el, d, f), ("experts", "d_model", "d_ff")),
        "w_down": TensorSpec((el, f, d), ("experts", "d_ff", "d_model")),
    }
    if cfg.expert_act == "swiglu":
        s["w_gate"] = TensorSpec((el, d, f), ("experts", "d_model", "d_ff"))
    elif cfg.expert_act != "relu2":
        raise ValueError(f"unknown expert activation {cfg.expert_act!r}")
    if cfg.router == "sigmoid":
        s["e_score_correction_bias"] = TensorSpec((e,), (None,),
                                                  init="zeros")
    elif cfg.router != "softmax":
        raise ValueError(f"unknown router {cfg.router!r}")
    if cfg.num_shared_experts:
        fs = cfg.shared_d_ff or f * cfg.num_shared_experts
        s["shared"] = (mlp_specs(d, fs) if cfg.expert_act == "swiglu"
                       else relu2_mlp_specs(d, fs))
    return s


def capacity(cfg: ModelConfig, seq: int) -> int:
    if cfg.dropless:  # an expert is chosen at most once a position
        return seq
    c = math.ceil(seq * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor)
    return max(4 * math.ceil(c / 4), 4)


def _route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
           bias: Optional[torch.Tensor] = None):
    """Router scores + normalised top-k gates and their experts. x:
    (B,S,d). Softmax: the probabilities, the top-k of them. Sigmoid: fp32
    logits, their sigmoids, the top-k chosen on the sigmoids plus the
    correction ``bias`` and gated by the sigmoids alone."""
    k = cfg.num_experts_per_tok
    if cfg.router == "sigmoid":
        f32 = torch.float32
        logits = contract("bsd,de->bse", x.to(f32), router.to(f32))
        probs = torch.sigmoid(logits)  # (B,S,E)
        choice = probs + bias.to(f32)
        _, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
        idx = idx[..., :k]  # (B,S,k)
        gate = torch.gather(probs, -1, idx)
        gate = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-20)
    else:
        logits = contract("bsd,de->bse", x, router).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)  # (B,S,E)
        gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = gate[..., :k], idx[..., :k]  # (B,S,k)
        gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True),
                                  min=1e-9)
    if cfg.routed_scale != 1.0:
        gate = gate * cfg.routed_scale
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


def _expert_ffn(xg, p, gate_table):
    """(B,E,C,d) tokens through per-expert SwiGLU (or relu² where ``p``
    has no ``w_gate``), gate-weighted."""
    u = contract("becd,edf->becf", xg, p["w_up"])
    if "w_gate" in p:
        g = contract("becd,edf->becf", xg, p["w_gate"])
        h = F.silu(g.to(torch.float32)).to(xg.dtype) * u
    else:
        h = relu2(u)
    out = contract("becf,efd->becd", h, p["w_down"])
    return out * gate_table[..., None]


def _held_rows(table, gate_table, slot, keep, first: int, n: int, c: int):
    """The tables' rows of experts ``first`` .. ``first + n - 1``, and the
    (token, choice) slots renumbered from their first slot; a slot of
    another expert is not kept."""
    rows = slice(first, first + n)
    lo = first * c
    mine = keep & (slot >= lo) & (slot < lo + n * c)
    return (table[:, rows], gate_table[:, rows],
            torch.where(mine, slot - lo, 0), mine)


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
    # on DTensors the combine reads whole slots, sequence by sequence (the
    # partial sums over the hidden units, or the backward's, reduced)
    out = constrain(out, ("batch", None, None, None))
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


def _shared(p, x):
    """The shared expert: SwiGLU, or relu² where it has no ``w_gate``."""
    sh = p["shared"]
    return mlp_apply(sh, x) if "w_gate" in sh else relu2_mlp_apply(sh, x)


def moe_apply(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
    tracer=NULL_TRACER,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    Under the optimized profile with a mesh installed, the experts are
    split over the mesh's model axis (``_moe_apply_shard_map``)."""
    ctx = moe_shard_map_ctx()
    if ctx is not None and not is_dtensor(x):
        return _moe_apply_shard_map(cfg, p, x, *ctx)
    if ctx is not None and _splits(cfg, x, *ctx):
        return _moe_shard_map_ranks(cfg, p, x, *ctx)

    b, s, d = x.shape
    e, first, n = cfg.num_experts, cfg.expert_first, cfg.n_experts_held
    c = capacity(cfg, s)
    probs, gate, idx = _route(cfg, p["router"], x,
                              p.get("e_score_correction_bias"))
    # each sequence on its own: on DTensors, each rank its sequences
    b_ = (0, None)
    table, gate_table, slot, keep = head_local(
        lambda g, i: _dispatch_tables(g, i, e, c, x.dtype), (), (b_, b_),
        (b_,) * 4, gate, idx)
    if tracer.enabled:
        count = tracer.metrics.counter
        count("moe.assignments").inc(idx.numel())
        count("moe.held_assignments").inc(
            int(((idx >= first) & (idx < first + n)).sum()))
        count("moe.dropped").inc(int((~keep).sum()))
    if n != e:  # this layer's share of the experts
        table, gate_table, slot, keep = _held_rows(
            table, gate_table, slot, keep, first, n, c)
    xg = _gather_tokens(x, table, slot, keep)
    out = _expert_ffn(xg, p, gate_table)
    y = _combine(out, slot, keep)
    if cfg.num_shared_experts:
        y = y + _shared(p, x)
    return y, _aux_loss(probs, idx, e)


class _GatherSequence(torch.autograd.Function):
    """All-gather along the sequence (dim 1) over a group, whose gradient
    is the reduce-scatter of the gathered gradient back onto the ranks'
    blocks. ``torch.distributed.nn.functional.all_gather`` computes the
    same forward, but on gloo its backward goes through scatters that
    take the group's ranks for global ranks, and fails on a subgroup."""

    @staticmethod
    def forward(ctx, x, group, m: int):
        import torch.distributed as dist

        ctx.group, ctx.m = group, m
        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        parts = [g.contiguous() for g in torch.chunk(grad, ctx.m, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


def _moe_apply_shard_map(cfg, p, x, mesh, batch_axes, model_axis):
    """This rank's part of the expert-parallel MoE on a ``DeviceMesh``
    (the reference's shard_map branch, ``src/repro/models/moe.py:146``),
    from the whole layer ``p`` on every rank: ``_moe_local`` of the rank's
    part of it (``_rank_part``)."""
    m = mesh_sizes(mesh)[model_axis]
    j = mesh.get_local_rank(model_axis)
    return _moe_local(cfg, _rank_part(cfg, p, j, m), x, mesh, batch_axes,
                      model_axis)


def _e_pad(cfg: ModelConfig, m: int) -> int:
    """The experts padded with zeros to a multiple of ``m``."""
    return -(-cfg.num_experts // m) * m


def _shared_split(f: int, m: int) -> None:
    """Refuse a shared expert whose ``f`` hidden units do not divide over
    the ``m`` ranks of the model axis."""
    if f % m:
        raise ValueError(f"the shared expert's {f} hidden units do not "
                         f"divide over {m} ranks")


def _rank_part(cfg: ModelConfig, p, j: int, m: int):
    """Rank ``j`` of ``m``'s part of the whole layer ``p``, as the
    reference's ``in_specs`` split it: its ``el = e_pad / m`` experts (the
    experts padded with zeros to a multiple of m), its 1 / m of the shared
    expert's hidden units (columns of ``w_gate`` and ``w_up``, rows of
    ``w_down``) and the whole router."""
    e = cfg.num_experts
    el = _e_pad(cfg, m) // m

    def experts(w):  # this rank's rows of the zero-padded expert weights
        w = w[j * el:min((j + 1) * el, e)]
        if w.shape[0] < el:
            w = F.pad(w, (0, 0, 0, 0, 0, el - w.shape[0]))
        return w

    out = {"router": p["router"], "w_gate": experts(p["w_gate"]),
           "w_up": experts(p["w_up"]), "w_down": experts(p["w_down"])}
    if cfg.num_shared_experts:
        sh = p["shared"]
        f = sh["w_gate"].shape[1]
        _shared_split(f, m)
        cols = slice(j * f // m, (j + 1) * f // m)
        out["shared"] = {"w_gate": sh["w_gate"][:, cols],
                         "w_up": sh["w_up"][:, cols],
                         "w_down": sh["w_down"][cols]}
    return out


def _moe_local(cfg, p, x, mesh, batch_axes, model_axis):
    """This rank's part of the expert-parallel MoE, from its part ``p`` of
    the layer (``_rank_part``'s).

    ``x`` is the rank's block of the residual stream, (B / data, S, d), or
    under ``cfg.sequence_parallel`` (B / data, S / m, d) with m the model
    axis's size; ``y`` comes back in the same block. The rank routes over
    the full expert set, builds the tables over ``e_pad`` and keeps its
    own ``el`` rows of them; its combine adds the slots of its experts in
    expert order. The partial outputs are summed over the model axis
    (reduce-scattered along the sequence under ``sequence_parallel``,
    after the sequence was gathered on entry), and the aux loss of each
    batch shard is averaged over the batch axes.

    The collectives are ``torch.distributed.nn.functional``'s (the
    sequence's gather is ``_GatherSequence``), whose backward passes are
    the adjoints of their forward ones: autograd gives each rank its part
    of the gradient of the sum of the ranks' objectives, and a tensor that
    several ranks hold whole has for its gradient the sum of theirs."""
    import torch.distributed.nn.functional as dnn

    sizes = mesh_sizes(mesh)
    m = sizes[model_axis]
    j = mesh.get_local_rank(model_axis)
    group = mesh.get_group(model_axis)
    e = cfg.num_experts
    e_pad = _e_pad(cfg, m)
    el = e_pad // m

    # the reference anchors x replicated over the model axis here; with a
    # sequence-parallel residual that constraint gathers the sequence
    x = constrain(x, ("batch", None, None))
    if cfg.sequence_parallel:
        x = _GatherSequence.apply(x, group, m)
    c = capacity(cfg, x.shape[1])

    # routing over the FULL expert set, identical on every model shard
    probs, gate, idx = _route(cfg, p["router"], x,
                              p.get("e_score_correction_bias"))
    table, gate_table, slot, keep = _dispatch_tables(gate, idx, e_pad, c,
                                                     x.dtype)
    # this shard's experts' rows of the tables, and its (token, choice)
    # slots renumbered from its first slot
    table, gate_table, slot_l, mine = _held_rows(table, gate_table, slot,
                                                 keep, j * el, el, c)
    xg = _gather_tokens(x, table, slot_l, mine)
    out = _expert_ffn(xg, p, gate_table)
    y = _combine(out, slot_l, mine)
    if cfg.num_shared_experts:
        y = y + _shared(p, x)
    if cfg.sequence_parallel:
        # combine + reshard in one collective: the residual stream is
        # sequence-sharded over the model axis
        parts = list(torch.chunk(y, m, dim=1))
        y = dnn.reduce_scatter(torch.empty_like(parts[0]), parts, group=group)
    else:
        y = dnn.all_reduce(y, group=group)
    # per-data-shard load-balance loss, averaged across shards (the
    # standard GShard/Switch practice; differs from the global-batch aux
    # by O(cross-shard covariance))
    aux = _aux_loss(probs, idx, e)
    for a in batch_axes:
        aux = dnn.all_reduce(aux, group=mesh.get_group(a))
    return y, aux / math.prod(sizes[a] for a in batch_axes)


def _splits(cfg, x, mesh, batch_axes, model_axis) -> bool:
    """Whether ``x``'s batch divides over ``batch_axes`` (and, under
    ``cfg.sequence_parallel``, its sequence over the model axis), as the
    expert-parallel branch's blocks need. A decode step of one sequence
    (long_500k) does not: there the DTensor step takes the baseline
    dispatch, which computes the same function."""
    sizes = mesh_sizes(mesh)
    b = math.prod(sizes[a] for a in batch_axes)
    m = sizes[model_axis] if cfg.sequence_parallel else 1
    return x.shape[0] % b == 0 and x.shape[1] % m == 0


def _moe_shard_map_ranks(cfg, p, x, mesh, batch_axes, model_axis):
    """The expert-parallel branch on DTensors: ``_moe_local`` on each
    rank's block through ``local_map``, as the reference's ``shard_map``
    runs ``local_fn``, with its ``in_specs``: ``x`` with the batch over
    ``batch_axes`` (and the sequence over the model axis under
    ``cfg.sequence_parallel``, else whole there), the experts split over
    the model axis (padded with zeros to a multiple of it), the shared
    expert's hidden units split over it, the router whole, every weight
    whole over the batch axes. ``y`` comes back in ``x``'s block and the
    aux loss replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = list(mesh_sizes(mesh))
    m = mesh_sizes(mesh)[model_axis]
    rep = Replicate()

    def over_model(dim):  # split over the model axis, whole elsewhere
        return tuple(Shard(dim) if a == model_axis else rep for a in names)

    x_pl = tuple(Shard(0) if a in batch_axes else
                 Shard(1) if a == model_axis and cfg.sequence_parallel
                 else rep for a in names)
    pad = _e_pad(cfg, m) - cfg.num_experts
    experts = [F.pad(p[k], (0, 0, 0, 0, 0, pad)) if pad else p[k]
               for k in ("w_gate", "w_up", "w_down")]
    leaves = [p["router"]] + experts
    pls = [(rep,) * len(names)] + [over_model(0)] * 3
    if cfg.num_shared_experts:
        sh = p["shared"]
        _shared_split(sh["w_gate"].shape[1], m)
        leaves += [sh["w_gate"], sh["w_up"], sh["w_down"]]
        pls += [over_model(1), over_model(1), over_model(0)]

    def local(x_l, router, wg, wu, wd, *shared):
        part = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        if shared:
            part["shared"] = dict(zip(("w_gate", "w_up", "w_down"), shared))
        return _moe_local(cfg, part, x_l, mesh, batch_axes, model_axis)

    # each rank's part of the gradient: a partial sum wherever the rank
    # holds a block whole that other ranks' sequences or experts also use
    def grad(pl):
        return tuple(Partial() if q == rep else q for q in pl)

    return local_map(local, out_placements=(x_pl, (rep,) * len(names)),
                     in_placements=(x_pl, *pls),
                     in_grad_placements=(grad(x_pl), *map(grad, pls)),
                     redistribute_inputs=True, device_mesh=mesh,
                     )(x, *leaves)
