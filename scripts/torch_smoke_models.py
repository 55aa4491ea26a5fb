#!/usr/bin/env python3
"""The reduced variant of every architecture through the port: forward,
loss and gradient norm, prefill and one decode step.

    PYTHONPATH=src python scripts/torch_smoke_models.py --device cpu
    PYTHONPATH=src python scripts/torch_smoke_models.py mamba2-130m  # card

The port's twin of ``scripts/smoke_models.py``: the same batch shapes (2 x
32 tokens, codebook tokens and image embeddings where the config has
them), one line per architecture, and a failure if a loss, a gradient norm
or a decode logit is not finite. With no ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, get_device, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.spec import DTYPES  # noqa: E402


def batch_for(cfg, device, b: int = 2, s: int = 32) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    tok = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                        device=device)
    batch = {"tokens": tok, "labels": tok}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(
            (b, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device=device).to(DTYPES[cfg.dtype])
    return batch


def smoke(name: str, device) -> bool:
    """One architecture's line; True when every number is finite."""
    cfg = configs.get_config(name).reduced()
    batch = batch_for(cfg, device)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(1))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads))
    logits_p, cache = M.prefill(cfg, params, batch["tokens"],
                                image_embeds=batch.get("image_embeds"))
    logits_d, cache = M.decode_step(cfg, params, cache,
                                    batch["tokens"][:, :1])
    ok = bool(torch.isfinite(loss) and torch.isfinite(gnorm)
              and torch.isfinite(logits_d).all())
    print(f"{name:28s} loss={float(loss):8.4f} gnorm={float(gnorm):10.4f} "
          f"logits={tuple(logits_p.shape)} decode={tuple(logits_d.shape)} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="architectures (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    configs.load_all()
    failed = [n for n in args.names or configs.ARCH_IDS
              if not smoke(n, device)]
    if failed:
        raise AssertionError(f"not finite: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
