"""Public wrappers over the fusion kernels, operating on model-update trees
(the paper's "list of one-dimensional vectors, one per layer"): leaves are
flattened, fused leaf-wise by the kernels, and reshaped back.

The device of the tensors decides the route: on the card the CUDA kernels,
on the CPU their plain versions (the reference's ``interpret`` flag).
``bn`` / ``kb`` choose the kernels' launch shape, as the reference's choose
its tile (``_tile_kwargs``): the elements a block owns and the elements a
thread (``kernels.build.launch_shape``; None is the default;
``kernels.autotune.autotune`` gives the searched choice). The plain
versions ignore them."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import Pytree, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.batch_fold import batch_fold
from repro_torch.kernels.fused_agg import fused_agg
from repro_torch.kernels.pair_fuse import pair_fuse_many
from repro_torch.kernels.quant_agg import quant_agg, quantize


def fuse_updates(
    updates: Sequence[Pytree],
    weights: Optional[Sequence[float]] = None,
    *,
    bn: Optional[int] = None,
    kb: Optional[int] = None,
) -> Pytree:
    """Weighted fusion of K model updates (FedAvg-style weighted mean when
    weights sum to 1). Leaf-wise: stacks each leaf across updates and runs
    the fused_agg kernel once per leaf."""
    k = len(updates)
    if k < 1:
        raise ValueError("fuse_updates needs at least one update")
    if weights is None:
        weights = [1.0 / k] * k

    w = torch.tensor(list(weights), dtype=torch.float32,
                     device=tree_leaves(updates[0])[0].device)

    def fuse_leaf(*leaves: torch.Tensor) -> torch.Tensor:
        stack = torch.stack([l.reshape(-1) for l in leaves])  # (K, N)
        out = fused_agg(stack, w, bn=bn, kb=kb)
        return out.reshape(leaves[0].shape).to(leaves[0].dtype)

    return tree_map(fuse_leaf, *updates)


def accumulate(acc: Optional[Pytree], update: Pytree, weight: float, *,
               bn: Optional[int] = None, kb: Optional[int] = None) -> Pytree:
    """Streaming (incremental) fusion: acc + weight*update, OUT OF PLACE.

    This is the streaming fold (``FusionState.fold``; ``drain`` folds a
    backlog with ``accumulate_batch``): each update is folded
    into the running fp32 accumulator with the pair_fuse kernel, one
    launch a fold that covers every leaf (``pair_fuse_many``: a table of
    the leaves, one table a dtype pair), so aggregation state is one
    model-sized buffer regardless of K. A new
    accumulator is returned because a checkpointed partial aggregate holds
    the old one by reference. The kernel reads a bf16 update directly; the
    sum is the one the fp32 copy of the update would give."""
    if acc is None:
        return tree_map(lambda u: u.to(torch.float32) * weight, update)
    return tree_unflatten(acc, pair_fuse_many(
        tree_leaves(acc), tree_leaves(update), op="wsum", wa=1.0,
        wb=float(weight), bn=bn, kb=kb))


def accumulate_batch(acc: Optional[Pytree], updates: Sequence[Pytree],
                     weights: Sequence[float], *,
                     in_place: bool = False) -> Pytree:
    """The streaming fold of up to ``batch_fold.C_MAX`` updates at once:
    ``acc + w_0 u_0 + ... `` in message order, the same bits as
    ``accumulate`` of each in turn, in one ``batch_fold`` launch that
    covers every leaf; with no ``acc`` a new accumulator starts at the
    first update. Out of place unless ``in_place``, which updates ``acc``
    itself: only an accumulator that no checkpoint holds may be."""
    outs = batch_fold(None if acc is None else tree_leaves(acc),
                      [tree_leaves(u) for u in updates], weights,
                      in_place=in_place)
    return tree_unflatten(updates[0] if acc is None else acc, outs)


def fuse_quantized(
    q_updates: Sequence[Pytree],
    scales: Sequence[Pytree],
    weights: Optional[Sequence[float]] = None,
    *,
    bn: Optional[int] = None,
    kb: Optional[int] = None,
) -> Pytree:
    """Fuse int8-quantised updates (beyond-paper comm compression).

    q_updates: K trees of int8 leaves; scales: K trees of 0-d fp32 scales.
    One quant_agg launch per leaf; the fused leaves stay fp32. Each row's
    scale is ``scale * weight`` taken in Python doubles and only then cast
    to fp32, as the reference does (one host sync per leaf and party)."""
    k = len(q_updates)
    if k < 1:
        raise ValueError("fuse_quantized needs at least one update")
    if weights is None:
        weights = [1.0 / k] * k
    qs = [tree_leaves(u) for u in q_updates]
    ss = [tree_leaves(s) for s in scales]
    fused = []
    for i, leaf in enumerate(qs[0]):
        stack = torch.stack([l[i].reshape(-1) for l in qs])  # (K, N) int8
        sc = torch.tensor([float(ss[j][i]) * weights[j] for j in range(k)],
                          dtype=torch.float32, device=stack.device)
        fused.append(quant_agg(stack, sc, bn=bn, kb=kb).reshape(leaf.shape))
    return tree_unflatten(q_updates[0], fused)


def quantize_update(update: Pytree) -> Tuple[Pytree, Pytree]:
    """Party-side int8 quantisation of a model update (per-leaf scales):
    a tree of int8 leaves in the update's shapes and a tree of 0-d fp32
    scales."""
    qs, ss = [], []
    for leaf in tree_leaves(update):
        q, s = quantize(leaf)
        qs.append(q.reshape(leaf.shape))
        ss.append(s)
    return tree_unflatten(update, qs), tree_unflatten(update, ss)
