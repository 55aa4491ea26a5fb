"""Gloo ranks for the port's sharding tests (``test_torch_shard_ranks.py``).

``run_ranks`` spawns one CPU process per rank of a ``data x model`` mesh.
Each joins a gloo process group through a ``FileStore`` in the test's
temporary directory (never a fixed port: parallel test workers would
collide), builds ``make_host_mesh(data, model, device="cpu")``, runs the
named cases and sends numpy results back. Every wait is bounded, so a hung
rank fails the test instead of eating the suite's time. This module imports
torch, numpy and the port only, so the ranks start without JAX; the
inputs are drawn here with numpy, and the test draws the same ones for
the reference.
"""
import multiprocessing as mp
import traceback
from datetime import timedelta

import numpy as np

AUX_W = 3.0  # the aux loss's weight in the MoE cases' objective
LOCAL_SPECS = [(None, None), ("data", None), (None, "model"),
               ("data", "model"), ("model", "data"),
               (("data", "model"), None), (None, ("model", "data"))]
# (logical axes, global shape, sequence_parallel) for ``constrain``
CONSTRAIN_CASES = [
    (("batch", "seq", "d_model"), (4, 8, 6), False),
    (("batch", "seq", "d_model"), (4, 8, 6), True),
    (("batch", "seq", "d_model"), (3, 8, 6), True),  # batch does not divide
    (("batch", None, "vocab"), (4, 5, 10), False),
    (("batch", None, "vocab"), (4, 5, 7), False),  # vocab does not divide
    (("batch", None, "kv_heads", None), (4, 8, 2, 3), True),
]
MOE_CASES = {
    # (config, reduced() overrides, mesh shape)
    "qwen2-moe": ("qwen2-moe-a2.7b", {}, (2, 2)),
    "qwen2-moe-pad": ("qwen2-moe-a2.7b", {"num_experts": 6}, (1, 4)),
    "llama4-sp": ("llama4-scout-17b-a16e", {"sequence_parallel": True},
                  (2, 2)),
}
MOE_SHAPE = (4, 32)  # (B, S)
# run_on_mesh's cases: reduced configs (fp32) of a dense, a MoE and an SSM
# family, and a sequence-parallel dense one, trained TRAIN_STEPS AdamW steps
# at TRAIN_SHAPE (B, S), the sequence-parallel one at two query chunks of
# attention (its K/V split along the sequence: the distributed softmax)
TRAIN_CONFIGS = {
    "qwen3-0.6b": dict(num_layers=2, d_model=64, vocab_size=128),
    "qwen2-moe-a2.7b": dict(num_layers=2, d_model=64, vocab_size=128,
                            num_experts=8, num_experts_per_tok=2,
                            num_shared_experts=2, d_ff=32),
    "mamba2-130m": dict(num_layers=2, d_model=64, vocab_size=128,
                        ssm_head_dim=32),
    "qwen2.5-14b": dict(num_layers=2, d_model=64, vocab_size=128,
                        sequence_parallel=True),
}
TRAIN_SHAPE = (4, 32)
TRAIN_SHAPES = {"qwen2.5-14b": (2, 512)}
TRAIN_STEPS = 2
# a decode step on DTensors: a reduced fp32 config with one KV head, so
# that on 2 x 2 the cache is split along its keys (cache_seq over the
# model axis), after a plain prefill of (B, prompt) into cap slots
DECODE_CONFIG = ("qwen3-0.6b", dict(num_layers=2, d_model=64,
                                    vocab_size=128, num_kv_heads=1))
DECODE_SHAPE = (4, 16, 24)  # (B, prompt, capacity)
FUSE_K, FUSE_N = 3, 4 * 1000


def moe_inputs(d_model, d_ff, experts, shared_ff, seed=0):
    """Whole-layer weights (fp32 numpy, scaled by fan-in), x and the
    objective's cotangent, from one seed."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale
                / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(d_model, experts, scale=0.5),
         "w_gate": w(experts, d_model, d_ff), "w_up": w(experts, d_model, d_ff),
         "w_down": w(experts, d_ff, d_model)}
    if shared_ff:
        p["shared"] = {"w_gate": w(d_model, shared_ff),
                       "w_up": w(d_model, shared_ff),
                       "w_down": w(shared_ff, d_model)}
    b, s = MOE_SHAPE
    x = rng.standard_normal((b, s, d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, d_model)).astype(np.float32)
    return p, x, ct


def fuse_inputs(seed=1):
    rng = np.random.default_rng(seed)
    stack = rng.standard_normal((FUSE_K, FUSE_N)).astype(np.float32)
    w = rng.random(FUSE_K).astype(np.float32)
    return stack, w / w.sum()


def train_shape(arch):
    """(B, S) of ``arch``'s run_on_mesh case."""
    return TRAIN_SHAPES.get(arch, TRAIN_SHAPE)


def train_config(arch):
    from repro_torch import configs

    configs.load_all()
    return configs.get_config(arch).reduced(dtype="float32",
                                            **TRAIN_CONFIGS[arch])


def decode_config():
    from repro_torch import configs

    configs.load_all()
    name, over = DECODE_CONFIG
    return configs.get_config(name).reduced(dtype="float32", **over)


def moe_config(case, dtype):
    from repro_torch import configs

    configs.load_all()
    name, over, _ = MOE_CASES[case]
    return configs.get_config(name).reduced(dtype=dtype, **over)


# --------------------------------------------------------------------------
# cases, run on every rank
# --------------------------------------------------------------------------
def _case_local_shard(mesh):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.sharding import NamedSharding, local_shard

    arr = np.random.default_rng(7).standard_normal((8, 12))
    t = torch.from_numpy(arr.astype(np.float32))
    out = []
    for spec in LOCAL_SPECS:
        sh = NamedSharding(mesh, spec)
        mine = local_shard(t, sh, mesh.get_coordinate())
        try:
            placements = sh.placements()
        except ValueError:  # two axes on a dim, out of mesh order
            out.append((mine.numpy().copy(), None))
            continue
        dt = distribute_tensor(t, mesh, placements).to_local()
        out.append((mine.numpy().copy(), dt.numpy().copy()))
    return out


def _case_constrain(mesh):
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.sharding import activation_rules
    from repro_torch.models.sharding_ctx import activation_sharding, constrain

    out = []
    for i, (axes, shape, sp) in enumerate(CONSTRAIN_CASES):
        arr = np.random.default_rng(i).standard_normal(shape)
        x = distribute_tensor(torch.from_numpy(arr.astype(np.float32)),
                              mesh, [Replicate()] * mesh.ndim)
        with activation_sharding(mesh, activation_rules(mesh, sp),
                                 "optimized"):
            y = constrain(x, axes)
        out.append((tuple(str(p) for p in y.placements),
                    y.to_local().numpy().copy(),
                    y.full_tensor().numpy().copy()))
    return out


def _case_moe(mesh, case, dtype):
    """This rank's part of the expert-parallel MoE on the whole inputs:
    the rank's block of the output, the aux loss, and the gradient of its
    share of the objective sum(y * ct) + AUX_W * aux with respect to the
    whole weights and the whole x. A block that m ranks hold alike counts
    1 / m in each, so the shares sum to the objective, and the sum of the
    ranks' gradients is its gradient."""
    import torch

    from repro_torch import tree_leaves, tree_map
    from repro_torch.launch.sharding import NamedSharding, local_shard
    from repro_torch.models.moe import _moe_apply_shard_map
    from repro_torch.models.sharding_ctx import mesh_sizes
    from repro_torch.models.spec import DTYPES

    cfg = moe_config(case, dtype)
    dt = DTYPES[dtype]
    p_np, x_np, ct_np = moe_inputs(
        cfg.d_model, cfg.d_ff, cfg.num_experts,
        cfg.d_ff * cfg.num_shared_experts)
    p = tree_map(lambda a: torch.from_numpy(a).to(dt).requires_grad_(), p_np)
    x = torch.from_numpy(x_np).to(dt).requires_grad_()
    blk = NamedSharding(mesh, ("data", "model" if cfg.sequence_parallel
                               else None, None))
    coords = mesh.get_coordinate()
    y, aux = _moe_apply_shard_map(cfg, p, local_shard(x, blk, coords), mesh,
                                  ("data",), "model")
    alike = 1 if cfg.sequence_parallel else mesh_sizes(mesh)["model"]
    ct = local_shard(torch.from_numpy(ct_np), blk, coords)
    share = ((y.float() * ct).sum() / alike
             + AUX_W * aux.float() / mesh.size())
    share.backward()
    return {"y": y.detach().float().numpy(), "aux": float(aux.detach()),
            "grads": [g.grad.float().numpy() for g in tree_leaves(p)],
            "x": x.grad.float().numpy()}


def _case_fuse(mesh):
    import torch
    import torch.distributed.nn.functional as dnn
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.benchmarks.dist_agg import (_update_sharding,
                                                 count_collectives,
                                                 fuse_sharded)

    stack_np, w_np = fuse_inputs()
    stack, w = torch.from_numpy(stack_np), torch.from_numpy(w_np)
    dstack = distribute_tensor(stack, mesh,
                               _update_sharding(mesh).placements())
    out, n = count_collectives(lambda: fuse_sharded(dstack, w, mesh))
    # the counter sees a gloo collective when there is one
    _, control = count_collectives(
        lambda: dnn.all_reduce(torch.ones(2), group=mesh.get_group("model")))
    return {"local": out.to_local().numpy().copy(), "collectives": n,
            "control": control,
            "placements": tuple(str(p) for p in out.placements),
            "global_shape": tuple(out.shape)}


def _case_train(mesh, arch, params):
    """``run_on_mesh``'s losses, from the whole weights ``params``
    (numpy), each rank keeping its blocks."""
    from repro_torch import interop
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.train import run_on_mesh

    b, s = train_shape(arch)
    out = run_on_mesh(train_config(arch), InputShape("t", s, b, "train"),
                      mesh, steps=TRAIN_STEPS, device="cpu",
                      params=interop.to_torch(params, "cpu"),
                      log=lambda line: None)
    return [r["loss"] for r in out]


def _case_decode(mesh, params, prompt, token):
    """A plain prefill of ``prompt`` on every rank, then one decode step of
    ``token`` on DTensors, each rank holding its blocks of the weights and
    of the cache: the whole logits, and the dims along which the K cache
    (layers, B, slots, KV, D) is split over each mesh dim."""
    import torch

    from repro_torch import interop, tree_leaves
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import layout, steps
    from repro_torch.models import model as M

    cfg = decode_config()
    b, _, cap = DECODE_SHAPE
    p = interop.to_torch(params, "cpu")
    _, cache = M.prefill(cfg, p, torch.from_numpy(prompt), capacity=cap)
    p_sh, c_sh, t_sh = steps.shardings(cfg, InputShape("t", cap, b,
                                                       "decode"), mesh)
    dargs = (layout.distribute(p, p_sh, mesh),
             layout.distribute(cache, c_sh, mesh),
             layout.distribute_one(torch.from_numpy(token), t_sh, mesh))
    (logits, _), _ = layout.run_step(
        lambda a, c, t: M.decode_step(cfg, a, c, t), dargs, mesh, cfg,
        record=False)
    k = max(tree_leaves(dargs[1]), key=lambda x: x.numel())
    return {"logits": logits.full_tensor().numpy(),
            "k_split_dims": tuple(getattr(q, "dim", None)
                                  for q in k.placements)}


CASES = {"local_shard": _case_local_shard, "constrain": _case_constrain,
         "moe": _case_moe, "fuse": _case_fuse, "train": _case_train,
         "decode": _case_decode}


# --------------------------------------------------------------------------
# spawning
# --------------------------------------------------------------------------
def _rank_main(rank, world, mesh_shape, store_path, cases, queue):
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=60))
        try:
            mesh = make_host_mesh(*mesh_shape, device="cpu")
            out = {"coords": tuple(mesh.get_coordinate())}
            for key, name, kw in cases:
                out[key] = CASES[name](mesh, **kw)
        finally:
            dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def run_ranks(mesh_shape, cases, tmp_path, timeout=120.0):
    """Run ``cases`` ((key, case name, kwargs) triples) on every rank of a
    ``mesh_shape`` mesh of gloo CPU ranks; returns {rank: {key: result,
    "coords": mesh coordinates}}. Raises if a rank fails or does not
    answer within ``timeout`` seconds."""
    world = mesh_shape[0] * mesh_shape[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, mesh_shape, store, cases, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return out
