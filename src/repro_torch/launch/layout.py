"""A whole model step on DTensors over the reference's production layout,
and the record of the collectives it asks for.

  with layout_group(256):
      mesh = make_production_mesh()
      fn, args, _ = steps.build(cfg, shape)
      out, record = run_step(fn, distribute(args, steps.shardings(
          cfg, shape, mesh), mesh), mesh, cfg)

``layout_group`` starts a layout-only process group (the ``fake``
backend: every collective returns at once and moves nothing) of 256 or 512
ranks in this one process, so ``make_production_mesh`` builds the
reference's 16 x 16 or 2 x 16 x 16 mesh with no cards. ``distribute``
turns ``steps.build``'s "meta" arguments into DTensors placed by
``steps.shardings``: each leaf's local block has the shape of the rank's
shard (``sharding.local_shard``) and no storage, so a full-size model
allocates nothing. On a real group (gloo CPU ranks, NCCL cards) the same
function keeps only the rank's block of a materialised tensor.

``run_step`` runs the step once under the activation rules of the profile
and returns its output with a ``CollectiveRecord`` (unless told not to
record, as a step on real data is): one ``Collective`` for
every collective the DTensors issue (the step's own ``redistribute``s,
DTensor's sharding propagation, and the MoE branch's
``torch.distributed.nn`` calls), with the reference's kind, its output
bytes at the tensor's own dtype, its group size and the port's call site.

The mesh is of the "cpu" device type on the layout-only group. A "cuda"
mesh builds there too, but DTensor propagates shapes on fake tensors of
the mesh's device type, and on a CPU-only build of PyTorch a fake "cuda"
tensor cannot be made contiguous, which the backward needs. On a "cpu"
mesh DTensor replaces an all-to-all (``shard_dim_alltoall``) by an
all-gather and a chunk, because gloo has no all-to-all; the record counts
what the layout asked for, one all-to-all of the chunk's bytes, by its
call from ``shard_dim_alltoall``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import re
import sys
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import Pytree, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.dryrun import _shape_bytes

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
LAYOUT_DEVICE = "cpu"

# operator -> the reference's kind (functional collectives, which DTensor
# issues, and the c10d ops behind torch.distributed and its nn functions)
_KIND = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
}
_PORT = os.sep + "repro_torch" + os.sep


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


_FLOPS = _flop_formulas()


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective: the reference's kind, the bytes of its output on a
    rank (at the tensor's dtype), the ranks of its group, the port's call
    site (``models/attention.py:148``; the innermost frame under
    ``repro_torch/models/``, else under ``repro_torch/``), the output's
    shape and dtype, whether autograd's backward issued it, and whether
    it gathers a parameter (its input shares the storage of a parameter's
    local block: a layer's slice of it, or the block itself)."""

    kind: str
    nbytes: int
    group_size: int
    site: str
    shape: Tuple[int, ...]
    dtype: str
    backward: bool
    param: bool = False


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return _shape_bytes(t.shape, t.dtype)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _group_size(args) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    name = args[-1]
    return _resolve_process_group(name).size() if isinstance(
        name, str) else 1


def _rel(path: str, line) -> Optional[str]:
    i = path.rfind(_PORT)
    if i < 0:
        return None
    return f"{path[i + len(_PORT):]}:{line}".replace(os.sep, "/")


_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+)')


def _site(node) -> Tuple[str, bool]:
    """(the port's innermost call site, whether DTensor's all-to-all
    fallback on a "cpu" mesh is on the stack). In the backward, with
    anomaly mode on, the site is that of the forward op that made
    ``node``. The innermost site under ``models/`` wins (its layout
    helpers in ``sharding_ctx.py`` aside), else the innermost of the
    port."""
    sites: List[str] = []
    fallback = False
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            fallback = True
        rel = _rel(f.f_code.co_filename, f.f_lineno)
        if rel is not None:
            sites.append(rel)
        f = f.f_back
    tb = node.metadata.get("traceback_") if node is not None else None
    if tb:
        fwd = [_rel(*m.groups()) for line in reversed(tb)
               for m in [_FRAME_RE.search(line)] if m]
        sites = [x for x in fwd if x is not None] or sites
    own = [x for x in sites if not x.startswith("models/sharding_ctx.py")]
    models = [x for x in own if x.startswith("models/")]
    return (models or own or sites or ["?"])[0], fallback


class CollectiveRecord(TorchDispatchMode):
    """A dispatch mode that records every collective run under it."""

    def __init__(self, params: Pytree = None):
        """``params``: the step's parameter DTensors, whose gathers are
        told apart (``Collective.param``). The blocks derived from them are
        kept alive, so that no other tensor's storage can take an address
        of theirs: give it only for "meta" blocks, which hold no memory."""
        super().__init__()
        self.items: List[Collective] = []
        self.flops = 0  # of the ranks' local matrix products (rank 0's)
        self._keep = [x.to_local() for x in tree_leaves(params)
                      if hasattr(x, "to_local")] if params is not None else []
        self._params = {_storage(t) for t in self._keep}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # let DTensor run first: it desugars into the local ops and
            # collectives that come back here (as in ``CommDebugMode``)
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _KIND.get(func._schema.name)
        count = _FLOPS.get(func._overloadpacket)
        if count is not None and not any(
                isinstance(t, FakeTensor) for t in _tensors(list(args))):
            # (DTensor's shape propagation runs some ops on fake tensors of
            # the global shape: those are not a rank's work)
            self.flops += int(count(*args, **(kwargs or {}), out_val=out))
        if kind is None:
            # a local op on parameter blocks alone (a slice, a movedim, the
            # copy that makes it contiguous) gives a parameter block
            ins = _tensors(list(args) + list((kwargs or {}).values()))
            if self._params and ins and all(
                    _storage(t) in self._params for t in ins):
                self._keep += _tensors(out)
                self._params.update(_storage(t) for t in _tensors(out))
        else:
            node = torch._C._current_autograd_node()
            site, fallback = _site(node)
            if func._schema.name in ("c10d::alltoall_base_", "c10d::send"):
                outs = _tensors(args[0])
            else:
                outs = _tensors(out)
            nbytes = sum(_nbytes(t) for t in outs)
            size = _group_size(args)
            t = outs[0] if outs else None
            if fallback and kind == "all-gather":
                # DTensor's stand-in for an all-to-all on a "cpu" mesh:
                # the all-to-all's output is one chunk of the gather's, of
                # its input's size
                kind, nbytes, t = "all-to-all", nbytes // size, args[0]
            src = _tensors(args[1] if func._schema.name in (
                "c10d::allgather_", "c10d::_allgather_base_") else args[0])
            self.items.append(Collective(
                kind, int(nbytes), int(size), site,
                tuple(t.shape) if t is not None else (),
                str(t.dtype).replace("torch.", "") if t is not None else "",
                node is not None,
                kind == "all-gather" and bool(src) and
                _storage(src[0]) in self._params))
        return out

    # ------------------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        c = Counter(x.kind for x in self.items)
        return {k: c.get(k, 0) for k in KINDS}

    def bytes_by_kind(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS}
        for x in self.items:
            out[x.kind] += x.nbytes
        return out

    def total_bytes(self) -> int:
        return sum(x.nbytes for x in self.items)

    def param_gathers(self) -> Tuple[int, int]:
        """(count, bytes) of the all-gathers of parameters."""
        g = [x.nbytes for x in self.items if x.param]
        return len(g), sum(g)


# --------------------------------------------------------------------------
# the layout-only group
# --------------------------------------------------------------------------
_DEVICE_TYPE = LAYOUT_DEVICE


def device_type() -> str:
    """The device type of the meshes ``launch.mesh`` builds in a
    layout-only group (``layout_group``'s)."""
    return _DEVICE_TYPE


@contextlib.contextmanager
def layout_group(world_size: int, device_type: str = LAYOUT_DEVICE
                 ) -> Iterator[str]:
    """A layout-only (``fake``) process group of ``world_size`` ranks in
    this process, this process rank 0, in which ``launch.mesh`` builds
    its meshes of ``device_type`` (which it yields). An existing group is
    kept as it is (and must be of that size); one this started is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    global _DEVICE_TYPE
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("fake", rank=0, world_size=world_size,
                                store=FakeStore())
    elif dist.get_world_size() != world_size:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is running, not {world_size}")
    prev, _DEVICE_TYPE = _DEVICE_TYPE, device_type
    try:
        yield device_type
    finally:
        _DEVICE_TYPE = prev
        if started:
            dist.destroy_process_group()


def is_layout_only() -> bool:
    """True inside ``layout_group``'s process group."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() == "fake"


# --------------------------------------------------------------------------
# DTensor arguments
# --------------------------------------------------------------------------
def local_shape(shape: Sequence[int], sharding: shd.NamedSharding
                ) -> Tuple[int, ...]:
    """The shape of a rank's block of a ``shape`` tensor."""
    sizes = shd.mesh_sizes(sharding.mesh)
    out = list(shape)
    for i, entry in enumerate(sharding.spec):
        out[i] //= math.prod(sizes[a] for a in shd.entry_axes(entry))
    return tuple(out)


def distribute_one(t: torch.Tensor, sharding: shd.NamedSharding, mesh):
    """``t`` as a DTensor placed by ``sharding``: a "meta" tensor gets a
    "meta" block of the rank's shape; any other keeps only the rank's
    block (a copy)."""
    from torch.distributed.tensor import DTensor

    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, sharding), dtype=t.dtype,
                            device="meta")
    else:
        local = shd.local_shard(t, sharding,
                                mesh.get_coordinate()).contiguous().clone()
    return DTensor.from_local(local, mesh, sharding.placements(),
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def distribute(args: Pytree, shardings: Pytree, mesh) -> Pytree:
    """Every tensor leaf of ``args`` through ``distribute_one`` with the
    matching leaf of ``shardings`` (``steps.shardings``'s tree)."""
    return tree_map(lambda t, sh: distribute_one(t, sh, mesh), args,
                    shardings)


def cache_shardings(cfg: ModelConfig, mesh, batch: int, capacity: int):
    """The decode cache's layout (``steps.CACHE_RULES``), which the
    prefill's cache takes too: the cache a prefill fills is the one decode
    reads."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    return shd.tree_shardings(M.cache_specs(cfg, batch, capacity), mesh,
                              steps.CACHE_RULES)


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------
def run_step(fn, dargs: Sequence, mesh, cfg: ModelConfig,
             profile: str = "baseline", backward_sites: bool = False,
             record: bool = True):
    """``fn(*dargs)`` on DTensors under the activation rules of
    ``profile``: returns (its output, the ``CollectiveRecord``, or None
    without ``record``: the record is a Python hook on every operator, a
    dry run's instrument, which a step on real data leaves off). Plain
    tensors the step makes (positions, masks, zeros) are taken as
    replicated (``implicit_replication``): every rank computes them alike.
    A prefill's fresh cache is laid out as decode's (``cache_shardings``).
    ``backward_sites`` turns autograd's anomaly mode on, so that a
    collective of the backward names the forward line it belongs to (at
    the cost of a stack trace an op)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.sharding_ctx import (activation_sharding,
                                                 cache_layout)

    rules = shd.activation_rules(mesh, cfg.sequence_parallel)
    params = dargs[0]
    meta = all(getattr(x, "device", None) == torch.device("meta")
               for x in tree_leaves(params))
    rec = CollectiveRecord(params if meta else None) if record else None

    def lay_out(cache, batch, capacity):
        return distribute(cache, cache_shardings(cfg, mesh, batch, capacity),
                          mesh)

    anomaly = (torch.autograd.detect_anomaly(check_nan=False)
               if backward_sites else contextlib.nullcontext())
    with activation_sharding(mesh, rules, profile=profile), \
            cache_layout(lay_out), implicit_replication(), anomaly, \
            rec if rec is not None else contextlib.nullcontext():
        out = fn(*dargs)
    return out, rec


def local_blocks(tree: Pytree) -> Pytree:
    """Each DTensor leaf's local block (other leaves as they are)."""
    return tree_map(lambda x: x.to_local() if hasattr(x, "to_local") else x,
                    tree)


def build_on_mesh(cfg: ModelConfig, shape, mesh, profile: str = "baseline"):
    """``steps.build``'s step and its "meta" arguments as DTensors on
    ``mesh``: (fn, dargs)."""
    from repro_torch.launch import steps

    fn, args, _ = steps.build(cfg, shape)
    return fn, distribute(args, steps.shardings(cfg, shape, mesh, profile),
                          mesh)
