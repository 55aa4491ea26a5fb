"""Serving launcher: prefill a batch of prompts, then greedy-decode with the
ring-buffer KV cache.

  # CPU smoke (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --reduced --prompt-len 16 --tokens 8 --device cpu

  # the full config on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 8 --prompt-len 1024 --tokens 128

The decode step runs eagerly (the reference jits it); it writes the cache
in place and never waits on the host, so the host runs ahead of the card
until a token is read back.
"""
import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import torch

from repro_torch import configs, get_device
from repro_torch.models import model as M
from repro_torch.models.spec import DTYPES


@dataclasses.dataclass
class Generation:
    # (B, steps + 1) int32, (B, steps + 1, K) with K codebooks: the
    # prefill's greedy token, then each step's
    tokens: torch.Tensor
    cache: dict
    finite: bool  # every logit of the prefill and of every step
    prefill_s: float
    step_s: List[float]  # each decode step (synchronised when timed)
    # (B, steps + 1, [K,] V) last-position
    logits: Optional[torch.Tensor] = None


def generate(cfg, params, prompt, steps: int, capacity: int, *,
             image_embeds: Optional[torch.Tensor] = None,
             timed: bool = False, keep_logits: bool = False) -> Generation:
    """Prefill ``prompt`` (B, S), or (B, S, K) with K codebooks, into a
    cache of ``capacity`` slots, take its greedy token, then ``steps``
    greedy decode steps. ``image_embeds`` (B, P, d) go to the prefill, which
    caches their cross-attention K/V for the steps. ``timed`` waits for the
    card after the prefill and after each step, so the times are the
    device's (host clock); otherwise they time the host's enqueue.
    ``keep_logits`` keeps every prediction's fp32 logits on the device."""

    def sync():
        if timed and prompt.device.type == "cuda":
            torch.cuda.synchronize(prompt.device)

    sync()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, prompt, capacity=capacity,
                              image_embeds=image_embeds)
    finite = torch.isfinite(logits).all()
    last = logits[:, -1:]
    del logits
    sync()
    prefill_s = time.perf_counter() - t0
    kept = [last] if keep_logits else []
    nxt = torch.argmax(last, dim=-1).to(torch.int32)
    out = [nxt]
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = M.decode_step(cfg, params, cache, nxt)
        finite &= torch.isfinite(logits).all()
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(nxt)
        if keep_logits:
            kept.append(logits[:, -1:])
        sync()
        step_s.append(time.perf_counter() - t0)
    return Generation(
        tokens=torch.cat(out, dim=1), cache=cache, finite=bool(finite),
        prefill_s=prefill_s, step_s=step_s,
        logits=torch.cat(kept, dim=1) if keep_logits else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--force-host", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.profile != "baseline" or args.force_host:
        raise NotImplementedError(
            "--profile optimized and --force-host need the production mesh "
            "and its shardings, which the port does not have yet")

    dev = get_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
    b, s = args.batch, args.prompt_len
    tok_shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    prompt = torch.randint(0, cfg.vocab_size, tok_shape,
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
    image_embeds = None
    if cfg.num_image_tokens:
        image_embeds = torch.zeros((b, cfg.num_image_tokens, cfg.d_model),
                                   dtype=DTYPES[cfg.dtype], device=dev)
    out = generate(cfg, params, prompt, args.tokens - 1, s + args.tokens,
                   image_embeds=image_embeds)
    print(f"prefill: {tuple(tok_shape) + (cfg.vocab_size,)} in "
          f"{out.prefill_s:.2f}s", flush=True)
    for i, dt in enumerate(out.step_s[:2]):
        print(f"decode {i}: {dt:.2f}s", flush=True)
    gen = out.tokens
    if not (bool((gen >= 0).all()) and bool((gen < cfg.vocab_size).all())):
        raise AssertionError("a generated token is outside the vocabulary")
    print(f"generated {tuple(gen.shape)} tokens; first row: "
          f"{[int(x) for x in gen[0].flatten()[:8]]}")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
