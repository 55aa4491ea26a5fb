"""Training launcher: initialise a model on one device and run real AdamW
train steps on synthetic tokens.

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

``--profile optimized`` builds the reference's 1 x 1 mesh in the current
process group, starting a one-rank group when there is none (gloo on the
CPU, NCCL on the card) and destroying it at the end, and installs the
activation rules with the optimized profile. The reference's ``--shape``
and ``--force-host`` select its production mesh of 256 chips; they need a
whole model step on DTensors over a layout-only process group, which is
the port's slice 10 (ROADMAP Queue 1), and raise until then.
"""
import argparse
import contextlib
import sys
import time

import torch

from repro_torch import configs, get_device
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import one_rank_mesh
from repro_torch.launch.sharding import activation_rules
from repro_torch.models import model as M
from repro_torch.models.sharding_ctx import activation_sharding
from repro_torch.models.spec import DTYPES
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default=None,
                    help="an INPUT_SHAPES entry for the production mesh "
                         "(not ported yet)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--force-host", action="store_true",
                    help="force 512 host devices for the production mesh "
                         "(not ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.shape is not None or args.force_host:
        raise NotImplementedError(
            "--shape and --force-host run a step on the production mesh of "
            "256 chips, which waits for the port's slice 10 (ROADMAP Queue "
            "1); run on one device with --batch and --seq-len")

    dev = get_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = InputShape("smoke", args.seq_len, args.batch, "train")

    step = steps_mod.make_train_step(cfg)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw(3e-4).init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok_shape = (shape.global_batch, shape.seq_len)
    if cfg.num_codebooks:
        tok_shape += (cfg.num_codebooks,)
    with contextlib.ExitStack() as ctx:
        if args.profile == "optimized":
            mesh = ctx.enter_context(one_rank_mesh(dev))
            ctx.enter_context(activation_sharding(
                mesh, activation_rules(mesh, cfg.sequence_parallel),
                profile=args.profile))
        for i in range(args.steps):
            tokens = torch.randint(0, cfg.vocab_size, tok_shape,
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            batch = {"tokens": tokens,
                     "labels": torch.roll(tokens, -1, dims=1)}
            if cfg.num_image_tokens:
                batch["image_embeds"] = torch.zeros(
                    (shape.global_batch, cfg.num_image_tokens, cfg.d_model),
                    dtype=DTYPES[cfg.dtype], device=dev)
            t0 = time.time()
            params, opt_state, metrics = step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            print(f"step {i}: loss={loss:.4f} ({time.time()-t0:.4f}s)",
                  flush=True)
            if loss != loss:
                raise FloatingPointError("NaN loss")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
