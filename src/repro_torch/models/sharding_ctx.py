"""Activation-sharding context: lets launch-layer code install logical->mesh
rules that model code applies to the residual stream, without models
importing the launch layer. No-op when no rules are installed.

``constrain`` hints a layout where the reference's GSPMD constraint does:
a ``DTensor`` is redistributed to the placements the rules give, and a
plain tensor, which has no layout to hint, comes back unchanged (a GSPMD
constraint never changes values either). The port's models call it at the
reference's places, so with plain tensors every call is an identity.

More helpers let the models run on DTensors where DTensor's own rules do
not, each doing on a plain tensor exactly what the model did before:
``contract`` (an activation times a parameter, each rank computing its
block), ``lookup`` (an embedding lookup in a vocab-sharded table),
``head_local`` (a block computed sequence by sequence and head by head:
attention, the SSD and RG-LRU scans, the MoE's dispatch tables, run on
each rank's block through ``local_map``), ``write`` (an in-place copy into
a cache, the source first redistributed to the cache's placements) and
``write_slot`` (the ring-buffer write of one decode position).
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order, of a ``DeviceMesh`` or
    of a mapping of axis names to sizes (a layout with no ranks)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: None, an axis name or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh, spec) -> tuple:
    """DTensor placements of a spec (one entry per tensor dim: None, an
    axis name or a tuple of names), one per mesh dim: ``Shard(i)`` where
    tensor dim i names that mesh axis, else ``Replicate()``. A dim over two
    axes shards on both mesh dims, which DTensor splits in mesh order, the
    first mesh dim the major one; JAX splits in the spec's order, so the
    spec must name them in mesh order (the rules' ``("pod", "data")`` and
    ``("data", "model")`` do), else this raises."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_sizes(mesh))
    owner = {}
    for i, entry in enumerate(spec):
        names = entry_axes(entry)
        if [order.index(a) for a in names] != sorted(order.index(a)
                                                     for a in names):
            raise ValueError(f"DTensor splits a dim over mesh dims in mesh "
                             f"order {order}; {names} is not")
        owner.update((a, i) for a in names)
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in order)


_RULES: Optional[Dict[str, Optional[Tuple[str, ...]]]] = None
_MESH = None
_PROFILE = "baseline"
_CACHE_LAYOUT = None


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Optional[Tuple[str, ...]]],
                        profile: str = "baseline"):
    global _RULES, _MESH, _PROFILE
    prev, _RULES = _RULES, rules
    prev_mesh, _MESH = _MESH, mesh
    prev_prof, _PROFILE = _PROFILE, profile
    try:
        yield
    finally:
        _RULES = prev
        _MESH = prev_mesh
        _PROFILE = prev_prof


@contextlib.contextmanager
def cache_layout(fn):
    """Install ``fn`` ((cache tree, batch, capacity) -> the tree laid out on
    the mesh) for ``lay_out_cache``: the launch layer's cache placements, which the
    models do not import."""
    global _CACHE_LAYOUT
    prev, _CACHE_LAYOUT = _CACHE_LAYOUT, fn
    try:
        yield
    finally:
        _CACHE_LAYOUT = prev


def lay_out_cache(cache, batch: int, capacity: int):
    """A freshly made cache of ``batch`` x ``capacity`` slots (the
    prefill's) in the installed layout; as it is without one."""
    if _CACHE_LAYOUT is None:
        return cache
    return _CACHE_LAYOUT(cache, batch, capacity)


def is_optimized() -> bool:
    return _PROFILE == "optimized" and _MESH is not None


# features measured NET-NEGATIVE and excluded from the default optimized
# profile (kept selectable for the §Perf ablations): kv_anchor removes the
# per-chunk attention all-reduces (-5.2e11 B) but seq-replicates K/V through
# the remat stack (+3.8e11 B all-gather, 7.5x temp memory on the 90B VLM).
DEFAULT_OFF = {"kv_anchor"}


def opt_feature(name: str) -> bool:
    """True when the optimized profile is active and the named feature is
    enabled. REPRO_DISABLE_OPT / REPRO_ENABLE_OPT (comma-separated) override
    per feature — used for §Perf one-feature-at-a-time ablations. Features:
    moe_shard_map, kv_anchor, vocab_parallel, decode_tp_params."""
    if not is_optimized():
        return False
    off = {s.strip() for s in os.environ.get("REPRO_DISABLE_OPT", "").split(",") if s.strip()}
    on = {s.strip() for s in os.environ.get("REPRO_ENABLE_OPT", "").split(",") if s.strip()}
    if name in off:
        return False
    if name in DEFAULT_OFF and name not in on:
        return False
    return True


def moe_shard_map_ctx():
    """(mesh, batch_axes, model_axis) when the expert-parallel MoE dispatch
    is enabled (optimized profile), else None."""
    if not opt_feature("moe_shard_map"):
        return None
    names = set(mesh_sizes(_MESH))
    if "model" not in names:
        return None
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return _MESH, batch_axes, "model"


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    if _RULES is None or _MESH is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    # only constrain dims whose size divides the assigned axes
    sizes = mesh_sizes(_MESH)
    parts = []
    for dim, name in zip(x.shape, logical_axes):
        axes = _RULES.get(name) if name else None
        if axes:
            total = 1
            for a in axes:
                total *= sizes.get(a, 1)
            parts.append(axes if dim % total == 0 else None)
        else:
            parts.append(None)
    return x.redistribute(_MESH, spec_placements(_MESH, parts))


_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. Never imports DTensor's package (seconds
    on a card's host, at a model's first call): until something else has
    imported it, no DTensor exists."""
    global _DTENSOR
    if _DTENSOR is None:
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is None or not hasattr(mod, "DTensor"):
            return False
        _DTENSOR = mod.DTensor
    return isinstance(x, _DTENSOR)


def as_layout(src, dst):
    """``src`` in ``dst``'s placements where ``dst`` is a DTensor (else
    ``src`` itself): a DTensor is redistributed (which the collective
    record shows), a plain tensor, whose values every rank computes
    alike, is taken as replicated first (no collective)."""
    if not is_dtensor(dst):
        return src
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    return src.redistribute(dst.device_mesh, dst.placements)


def write(dst, src):
    """``dst.copy_(src)``; into a DTensor, ``src`` is first laid out as
    ``dst`` is, since an in-place op keeps its destination's placements."""
    if not is_dtensor(dst):
        return dst.copy_(src)
    return dst.copy_(as_layout(src, dst))


def write_slot(dst, dim: int, slot, src):
    """``dst.index_copy_(dim, slot, src)`` for a one-element ``slot``. On a
    DTensor whose ``dim`` may be sharded (a cache over ``cache_seq``),
    where an in-place index write has no sharding rule, the slot is
    selected by comparison with the positions along ``dim``, so each rank
    writes its own part."""
    if not is_dtensor(dst):
        return dst.index_copy_(dim, slot, src)
    shape = [1] * dst.ndim
    shape[dim] = dst.shape[dim]
    hit = (torch.arange(dst.shape[dim], device=dst.device)
           == slot.reshape(())).reshape(shape)
    return dst.copy_(as_layout(torch.where(hit, src, dst), dst))


def contract(eq: str, x, w, op=None, follow: Optional[str] = None):
    """``op(x, w)`` (``torch.einsum(eq, x, w)`` by default) for an
    activation ``x`` and a parameter ``w``, ``eq`` naming their dims.

    On DTensors each rank computes its block through ``local_map``, the
    block chosen mesh dim by mesh dim from the operands' placements as
    the reference's partitioner would (DTensor's own einsum picks
    shardings that a later view of the result cannot take, such as 8 KV
    heads over a 16-way axis): where ``x`` is sharded on a dim it keeps
    (the batch), ``w`` is gathered there (the FSDP gather of its d_model
    blocks, one per use); where ``w`` is sharded on a dim it keeps (heads,
    d_ff, vocab), ``x`` is replicated there and the result sharded; where
    both are sharded on the dim they contract, each rank's result is a
    partial sum. ``follow`` names a dim of ``w`` (the KV heads) that is
    split over the model axis where both operands are whole there and it
    divides, as the reference's partitioner splits the KV heads to follow
    the query heads. Every redistribution shows in the collective
    record."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return op(x, w) if op is not None else torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    # a leading "..." of x spelled out in letters no equation here uses
    lead = "ABCDEFG"[:x.ndim - len(xs) + 3] if "..." in xs else ""
    xs, ws, os_ = (t.replace("...", lead) for t in (xs, ws, out))
    rep = Replicate()
    mesh = (x if is_dtensor(x) else w).device_mesh
    px_l, pw_l, po_l = [], [], []
    for px, pw, name, n in zip(
            getattr(x, "placements", (rep,) * mesh.ndim),
            getattr(w, "placements", (rep,) * mesh.ndim),
            mesh.mesh_dim_names or (None,) * mesh.ndim, mesh.shape):
        # a dim split unevenly (60 experts over 16 ranks) is taken whole:
        # a rank's block then has no fixed size
        lx = xs[px.dim] if isinstance(px, Shard) and \
            x.shape[px.dim] % n == 0 else None
        lw = ws[pw.dim] if isinstance(pw, Shard) and \
            w.shape[pw.dim] % n == 0 else None
        if lx is not None and lx in os_:  # x keeps it: its batch
            blk = (px, Shard(ws.index(lx)) if lx in ws else rep,
                   Shard(os_.index(lx)))
        elif lw is not None and lw in os_:  # w keeps it: heads, d_ff
            blk = (Shard(xs.index(lw)) if lw in xs else rep, pw,
                   Shard(os_.index(lw)))
        elif lx is not None and lx in ws:  # both contract it
            blk = (px, Shard(ws.index(lx)), Partial())
        elif lw is not None and lw in xs:
            blk = (Shard(xs.index(lw)), pw, Partial())
        elif (follow is not None and name == "model"
              and w.shape[ws.index(follow)] % n == 0):
            blk = (rep, Shard(ws.index(follow)), Shard(os_.index(follow)))
        else:
            blk = (rep, rep, rep)
        for acc, pl in zip((px_l, pw_l, po_l), blk):
            acc.append(pl)
    # a gradient is a partial sum where its operand is whole but the
    # other one split: each rank's block of the product adds its share
    gx = tuple(Partial() if a == rep and b != rep else a
               for a, b in zip(px_l, pw_l))
    gw = tuple(Partial() if b == rep and a != rep else b
               for a, b in zip(px_l, pw_l))
    fn = op if op is not None else (lambda a, b: torch.einsum(eq, a, b))
    return local_map(fn, out_placements=(tuple(po_l),),
                     in_placements=(tuple(px_l), tuple(pw_l)),
                     in_grad_placements=(gx, gw),
                     redistribute_inputs=True, device_mesh=mesh)(x, w)


Dims = Optional[Tuple[Optional[int], Optional[int]]]


def head_local(fn, heads: Sequence[int], specs: Sequence[Dims],
               out_specs: Sequence[Dims], *args):
    """``fn(*args)``, for a ``fn`` that computes each sequence and each
    head on its own: ``specs[i]`` is (batch dim, head dim) of ``args[i]``
    (either None where it has none; None for a non-tensor), ``out_specs``
    the same for each result, and ``heads`` the head counts that must
    divide over a mesh dim to split it (a head dim may be heads x head
    size flattened). On DTensors each rank computes its block through
    ``local_map``, chosen mesh dim by mesh dim from ``args[0]``'s
    placement: its batch block where that is sharded on its batch dim,
    its heads where on its head dim and the heads divide, the whole
    otherwise (a redistribution the record shows). DTensor's own rules
    for these blocks' einsums and reshapes merge the batch with the heads
    and plan each redistribution of the merged dim as a graph search,
    which takes minutes on a three-dim mesh."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = args[0]
    mesh = lead.device_mesh
    bd0, hd0 = specs[0]
    ins = [[] for _ in args]
    outs = [[] for _ in out_specs]
    for p, n in zip(lead.placements, mesh.shape):
        pick = None
        if bd0 is not None and p == Shard(bd0) and lead.shape[bd0] % n == 0:
            pick = 0
        elif hd0 is not None and p == Shard(hd0) and all(
                h % n == 0 for h in heads):
            pick = 1
        for acc, spec in list(zip(ins, specs)) + list(zip(outs, out_specs)):
            d = spec[pick] if spec is not None and pick is not None else None
            acc.append(Shard(d) if d is not None else Replicate())
    in_pl = tuple(tuple(pl) if spec is not None and is_dtensor(a) else None
                  for pl, spec, a in zip(ins, specs, args))
    # a whole operand's gradient is a partial sum over the mesh dims that
    # split the work (each rank adds its sequences' or heads' share)
    split = [any(isinstance(pl[i], Shard) for pl in ins)
             for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else tuple(
        Partial() if s and p == Replicate() else p
        for p, s in zip(pl, split)) for pl in in_pl)
    args = tuple(a.redistribute(mesh, pl) if pl is not None else a
                 for a, pl in zip(args, in_pl))
    return local_map(fn, out_placements=tuple(tuple(o) for o in outs),
                     in_placements=in_pl, in_grad_placements=grads,
                     device_mesh=mesh)(*args)


def lookup(tokens, table):
    """``F.embedding(tokens, table)``. On DTensors each rank looks up its
    block through ``local_map``, mesh dim by mesh dim: where the tokens are
    split (the batch) the table is gathered there (a per-use gather, as
    the reference's take gathers it), unless the rank's tokens are fewer
    than the table's rows it holds (a decode step): then the tokens are
    gathered instead and the result keeps the table's split of d_model;
    where the table's vocab is split, each rank reads the tokens in its
    rows and writes zeros for the rest, and the results are partial sums;
    where its d_model is split, so is the result. (DTensor's own rule
    marks the masked rows with a buffer that loses the batch's layout on a
    two-dim mesh.)"""
    if not (is_dtensor(tokens) or is_dtensor(table)):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (table if is_dtensor(table) else tokens).device_mesh
    rep = Replicate()
    nd = tokens.ndim
    tok_pl, tab_pl, out_pl, vocab_dims = [], [], [], []
    t_pl = getattr(tokens, "placements", (rep,) * mesh.ndim)
    w_pl = getattr(table, "placements", (rep,) * mesh.ndim)
    held_rows = table.shape[0]
    for pw, n in zip(w_pl, mesh.shape):
        held_rows //= n if pw == Shard(0) else 1
    for i, (pt, pw, n) in enumerate(zip(t_pl, w_pl, mesh.shape)):
        few = tokens.numel() // n < held_rows
        if pt == Shard(0) and tokens.shape[0] % n == 0 and not (
                few and pw == Shard(1)):
            blk = (pt, rep, pt)
        elif pw == Shard(0) and table.shape[0] % n == 0:
            blk = (rep, pw, Partial())
            vocab_dims.append(i)
        elif pw == Shard(1) and table.shape[1] % n == 0:
            blk = (rep, pw, Shard(nd))
        else:
            blk = (rep, rep, rep)
        for acc, pl in zip((tok_pl, tab_pl, out_pl), blk):
            acc.append(pl)
    coords = mesh.get_coordinate()
    rows = table.shape[0]
    for i in vocab_dims:
        rows //= mesh.shape[i]

    def local(tok, tab):
        lo = 0
        for i in vocab_dims:  # the block's first row, major mesh dim first
            lo = lo * mesh.shape[i] + coords[i]
        idx = tok - lo * rows
        hit = (idx >= 0) & (idx < rows)
        out = F.embedding(torch.where(hit, idx, 0), tab)
        return torch.where(hit[..., None], out, 0)

    grad_tab = tuple(Partial() if b == rep and isinstance(a, Shard) else b
                     for a, b in zip(tok_pl, tab_pl))
    return local_map(local, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(tok_pl), tuple(tab_pl)),
                     in_grad_placements=(tuple(tok_pl), grad_tab),
                     redistribute_inputs=True, device_mesh=mesh,
                     )(tokens, table)
