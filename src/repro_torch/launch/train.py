"""Training launcher: initialise a model and run real AdamW train steps on
synthetic tokens, on one device or on a mesh.

  # CPU smoke (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --reduced --steps 5 --device cpu

  # the full config on the card, at --batch x --seq-len:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 5 --seq-len 128 --batch 8

  # the optimized profile: MoE layers take the expert-parallel branch on
  # a 1 x 1 mesh, as the reference's --reduced path builds
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \
      --reduced --steps 3 --profile optimized --device cpu

  # the production mesh (16 x 16) on 256 ranks, one per card:
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch qwen2.5-14b --shape train_4k

  # the production layout on this one process, dry (no data moves):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --shape train_4k --force-host --steps 2

``--profile optimized`` builds the reference's 1 x 1 mesh in the current
process group, starting a one-rank group when there is none (gloo on the
CPU, NCCL on the card) and destroying it at the end, and installs the
activation rules with the optimized profile.

``--shape NAME`` takes ``INPUT_SHAPES[NAME]`` on ``make_production_mesh()``
in the current process group (256 ranks under ``torchrun``: NCCL on
cards, gloo on CPU ranks; it raises ``RuntimeError`` naming the ranks it
needs otherwise). Parameters and optimizer state are DTensors placed by
``steps.shardings``, each rank holding only its block, and every step
runs through ``run_on_mesh``. ``--reduced`` overrides the shape and the
mesh, as in the reference: a reduced config trains on one device.

``--force-host`` is the counterpart of the reference's flag, which forces
512 host devices so that its production mesh builds on one CPU. Here it
starts a 256-rank layout-only process group in this process
(``launch.layout.layout_group``) and runs ``--steps`` dry steps on "meta"
DTensors over the 16 x 16 mesh (the reduced config at ``--batch`` x
``--seq-len`` with ``--reduced``, else ``--shape``, by default
train_4k). Each step prints the collectives it runs, by kind. It prints no
loss: a layout-only group moves no data, so there is none to print.
"""
import argparse
import contextlib
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import Pytree, configs, get_device, tree_map
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, one_rank_mesh
from repro_torch.launch.sharding import activation_rules
from repro_torch.models import model as M
from repro_torch.models.sharding_ctx import activation_sharding
from repro_torch.models.spec import DTYPES, abstract_params, init_leaf
from repro_torch.optim import adamw


def synthetic_batch(cfg: ModelConfig, shape: InputShape, gen: torch.Generator,
                    device) -> Dict[str, torch.Tensor]:
    """The launcher's batch: uniform tokens from ``gen``, the labels the
    tokens shifted by one, zero image embeddings for a VLM."""
    tok_shape = (shape.global_batch, shape.seq_len)
    if cfg.num_codebooks:
        tok_shape += (cfg.num_codebooks,)
    tokens = torch.randint(0, cfg.vocab_size, tok_shape, generator=gen,
                           device=device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.zeros(
            (shape.global_batch, cfg.num_image_tokens, cfg.d_model),
            dtype=DTYPES[cfg.dtype], device=device)
    return batch


def run_on_mesh(cfg: ModelConfig, shape: InputShape, mesh,
                profile: str = "baseline", steps: int = 5,
                device=None, params: Optional[Pytree] = None,
                log: Callable[[str], None] = print,
                count: bool = False) -> List[Dict]:
    """``steps`` AdamW steps of ``cfg`` at ``shape`` on ``mesh``, every
    tensor a DTensor placed by ``steps.shardings``; returns one dict a
    step: its ``loss`` (None when dry) and its collectives by kind
    (``collectives``, ``collective_bytes``). The collectives are counted
    (``layout.CollectiveRecord``, a hook on every operator) on a
    layout-only group, where they are all a step gives, and on a real one
    only with ``count``; else those two are None.

    On a real group each rank holds only its blocks: the parameters are
    ``params`` (whole tensors, as ``interop.to_torch`` gives them) or drawn
    leaf by leaf from a generator seeded 0 as ``model.init`` draws them,
    each rank keeping its block; the batches are drawn from a generator
    seeded 1 as ``main`` draws them. So on a 1 x 1 mesh this is ``main``'s
    run. On a layout-only group the steps are dry: "meta" blocks, and no
    loss."""
    from repro_torch.launch import layout

    dry = layout.is_layout_only()
    dev = torch.device("meta") if dry else get_device(device)
    sh = steps_mod.shardings(cfg, shape, mesh, profile)
    step = steps_mod.make_train_step(cfg)
    pspecs = M.param_specs(cfg)
    if dry:
        params = abstract_params(pspecs)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        # one whole leaf at a time, in model.init's order: each rank keeps
        # its block and lets the leaf go
        params = tree_map(lambda s, p_sh: layout.distribute_one(
            init_leaf(gen, s), p_sh, mesh), pspecs, sh[0])
    else:
        params = tree_map(lambda p, p_sh: layout.distribute_one(
            p.to(dev), p_sh, mesh), params, sh[0])
    opt_state = adamw(3e-4).init(params)
    gen = None if dry else torch.Generator(device=dev).manual_seed(1)
    out = []
    for i in range(steps):
        if dry:
            batch = abstract_params(steps_mod.batch_specs(cfg, shape))
        else:
            batch = synthetic_batch(cfg, shape, gen, dev)
        batch = layout.distribute(batch, sh[2], mesh)
        t0 = time.time()
        (params, opt_state, metrics), rec = layout.run_step(
            step, (params, opt_state, batch), mesh, cfg, profile,
            record=dry or count)
        counts = rec.counts() if rec is not None else None
        if dry:
            loss = None
            log(f"step {i}: collectives {counts} "
                f"bytes/device={rec.total_bytes():.4e} "
                f"({time.time() - t0:.2f}s; dry: no loss)")
        else:
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)  # waits for the step
            log(f"step {i}: loss={loss:.4f} ({time.time() - t0:.4f}s)")
            if loss != loss:
                raise FloatingPointError("NaN loss")
        out.append({"loss": loss, "collectives": counts,
                    "collective_bytes": rec.total_bytes()
                    if rec is not None else None})
    return out


def _mesh_device(device: Optional[str]) -> torch.device:
    """This rank's device under ``torchrun``: its card (``LOCAL_RANK``)
    unless ``device`` names another."""
    dev = get_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default=None,
                    help="an INPUT_SHAPES entry: train on the production "
                         "mesh (16 x 16) of the current process group")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config on one device")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--force-host", action="store_true",
                    help="dry steps on the production mesh of a 256-rank "
                         "layout-only group in this process: each prints "
                         "its collectives by kind, and no loss (no data "
                         "moves)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    smoke = InputShape("smoke", args.seq_len, args.batch, "train")

    if args.force_host:
        from repro_torch.launch.layout import layout_group

        shape = smoke if args.reduced else INPUT_SHAPES[
            args.shape or "train_4k"]
        with layout_group(256):
            run_on_mesh(cfg, shape, make_production_mesh(), args.profile,
                        args.steps)
        print("ok")
        return 0

    if args.shape is not None and not args.reduced:
        import torch.distributed as dist

        dev = _mesh_device(args.device)
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            # under torchrun: its environment names the group
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_production_mesh(device=dev.type)
        run_on_mesh(cfg, INPUT_SHAPES[args.shape], mesh, args.profile,
                    args.steps, dev)
        print("ok")
        return 0

    run_one_device(cfg, smoke, args.steps, args.device, args.profile)
    print("ok")
    return 0


def run_one_device(cfg: ModelConfig, shape: InputShape, steps: int,
                   device=None, profile: str = "baseline",
                   log: Callable[[str], None] = None) -> List[float]:
    """``steps`` AdamW steps of ``cfg`` at ``shape`` on one device, from
    ``model.init`` with seed 0 and batches from a generator seeded 1:
    ``main``'s run without a mesh. Returns the losses."""
    log = log or (lambda line: print(line, flush=True))
    dev = get_device(device)
    step = steps_mod.make_train_step(cfg)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw(3e-4).init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    with contextlib.ExitStack() as ctx:
        if profile == "optimized":
            mesh = ctx.enter_context(one_rank_mesh(dev))
            ctx.enter_context(activation_sharding(
                mesh, activation_rules(mesh, cfg.sequence_parallel),
                profile=profile))
        for i in range(steps):
            batch = synthetic_batch(cfg, shape, gen, dev)
            t0 = time.time()
            params, opt_state, metrics = step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            log(f"step {i}: loss={loss:.4f} ({time.time()-t0:.4f}s)")
            if loss != loss:
                raise FloatingPointError("NaN loss")
            losses.append(loss)
    return losses


if __name__ == "__main__":
    sys.exit(main())
