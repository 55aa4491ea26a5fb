#!/usr/bin/env python3
"""Whether mamba2-130m's bf16 greedy decode and its chunked forward part in
the JAX package as they do in the port.

    PYTHONPATH=src python3 scripts/torch_mamba2_bf16_agreement.py
    PYTHONPATH=src python3 scripts/torch_mamba2_bf16_agreement.py \
        --batch 2 --prompt 256 --tokens 32 --dtypes bfloat16 float32

About 2 minutes at the defaults (B 8, prompt 256, 64 tokens, bf16).

Both packages run on the CPU, mamba2-130m at full width and depth (24
layers, d_model 768, vocab 50,280), from the same weights and the same
prompt: the reference's initialisation (``seeded``), and the same weights
with ``dt_bias`` drawn as Mamba-2 initialises it (``conditioned``, as
``chip_smoke.conditioned`` draws it). Each package prefills the prompt into
prompt + tokens slots, takes ``tokens`` greedy decode steps through its
recurrent state, then runs one teacher-forced forward (the chunked SSD
pass) over the prompt and the generated tokens, padded at its end to a
whole number of 256-token chunks (the forward is causal: the padding moves
no earlier position). Printed for each package, weights and dtype: the
share of positions where the decode and the forward pick the same token
(for greedy tokens, the share of them the forward also picks: what
``chip_smoke.py`` reports), and the largest gap between their logits.

In bf16 the two packages' greedy streams part after a few tokens (their
sums round in other orders), so the port is also fed the reference's
stream: on the same tokens its decode-forward agreement is held against
the reference's, and its decode's picks against the reference's decode's.
The same agreement in both means the port copies the reference's
behaviour.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import conditioned  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

NAME = "mamba2-130m"
SEED = 0


def padded(seq: np.ndarray) -> np.ndarray:
    n = seq.shape[1]
    pad = (-n) % 256 if n > 256 else 0
    return np.pad(seq, ((0, 0), (0, pad)))


def port(cfg, params_np, prompt, tokens, feed=None):
    """(tokens (B, tokens + 1), their decode logits, the forward's logits
    at the same positions), all numpy. The tokens are the greedy ones, or
    ``feed``'s (B, tokens + 1) when given: each decode step then takes the
    fed token, not its own pick."""
    params = interop.to_torch(params_np, "cpu")
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, torch.from_numpy(prompt),
                                  capacity=prompt.shape[1] + tokens)
        kept = [logits[:, -1:].float()]
        out = [torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)]
        for i in range(tokens):
            nxt = out[-1] if feed is None else torch.from_numpy(
                feed[:, i:i + 1].copy())
            logits, cache = M.decode_step(cfg, params, cache, nxt)
            kept.append(logits[:, -1:].float())
            out.append(torch.argmax(logits[:, -1:], dim=-1).to(torch.int32))
        gen = torch.cat(out, dim=1).numpy() if feed is None else feed
        seq = padded(np.concatenate([prompt, gen[:, :-1]], axis=1))
        full, _, _ = M.forward(cfg, params, torch.from_numpy(seq))
    s = prompt.shape[1]
    return (gen, torch.cat(kept, dim=1).numpy(),
            full[:, s - 1:s - 1 + gen.shape[1]].float().numpy())


def reference(jcfg, params_np, prompt, tokens, feed=None):
    """The same in the JAX package: prefill, then the jitted
    ``decode_step`` as ``repro.launch.serve`` greedy-decodes."""
    params = jax.tree.map(
        lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                              else a), params_np)
    logits, cache = JM.prefill(jcfg, params, jnp.asarray(prompt),
                               capacity=prompt.shape[1] + tokens)
    step = jax.jit(lambda p, c, t: JM.decode_step(jcfg, p, c, t))
    kept = [logits[:, -1:]]
    out = [jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)]
    for i in range(tokens):
        nxt = out[-1] if feed is None else jnp.asarray(feed[:, i:i + 1])
        logits, cache = step(params, cache, nxt)
        kept.append(logits[:, -1:])
        out.append(jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
    gen = np.asarray(jnp.concatenate(out, axis=1)) if feed is None else feed
    seq = padded(np.concatenate([prompt, gen[:, :-1]], axis=1))
    full, _, _ = JM.forward(jcfg, params, jnp.asarray(seq))
    s = prompt.shape[1]
    return (gen, np.asarray(jnp.concatenate(kept, axis=1), np.float32),
            np.asarray(full[:, s - 1:s - 1 + gen.shape[1]], np.float32))


def weights(jcfg, which: str):
    """numpy tree (bf16 leaves as uint16 bits) of the reference's init,
    ``conditioned`` for ``which == "conditioned"``."""
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(SEED)))
    tree = jax.tree.map(
        lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
        tree)
    if which == "conditioned":
        t = conditioned(torch, interop.to_torch(tree, "cpu"),
                        torch.Generator().manual_seed(SEED))
        tree = interop.to_numpy(t)
    return tree


def report(label, dec, tf, t0) -> None:
    """The share of positions where the decode's logits ``dec`` and the
    forward's ``tf`` pick the same token, and their largest gap."""
    hit = tf.argmax(-1) == dec.argmax(-1)
    print(f"  {label}: decode and forward pick the same token at "
          f"{100 * float(hit.mean()):.2f} % of positions ({int(hit.sum())} of"
          f" {hit.size}), largest logit gap "
          f"{float(np.abs(tf - dec).max()):.4e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"])
    ap.add_argument("--weights", nargs="+",
                    default=["seeded", "conditioned"])
    args = ap.parse_args(argv)
    jconfigs.load_all()
    configs.load_all()
    rng = np.random.default_rng(SEED)
    base = configs.get_config(NAME)
    prompt = rng.integers(0, base.vocab_size, (args.batch, args.prompt)
                          ).astype(np.int32)
    print(f"{NAME}: {base.num_layers} layers, d_model {base.d_model}, "
          f"vocab {base.vocab_size}, SSD chunk {base.ssm_chunk}; B "
          f"{args.batch}, prompt {args.prompt}, {args.tokens} greedy "
          f"tokens; CPU")
    for dtype in args.dtypes:
        jcfg = dataclasses.replace(jconfigs.get_config(NAME), dtype=dtype)
        cfg = dataclasses.replace(base, dtype=dtype)
        for which in args.weights:
            tree = weights(jcfg, which)
            t0 = time.perf_counter()
            stream, ref_dec, tf = reference(jcfg, tree, prompt, args.tokens)
            report(f"{dtype} {which} reference, its own greedy tokens",
                   ref_dec, tf, t0)
            t0 = time.perf_counter()
            report(f"{dtype} {which} port, its own greedy tokens",
                   *port(cfg, tree, prompt, args.tokens)[1:], t0)
            t0 = time.perf_counter()
            _, dec, tf = port(cfg, tree, prompt, args.tokens, stream)
            report(f"{dtype} {which} port, fed the reference's tokens", dec,
                   tf, t0)
            same = float((dec.argmax(-1) == ref_dec.argmax(-1)).mean())
            print(f"  {dtype} {which}: on the reference's tokens the two "
                  f"decodes pick the same next token at {100 * same:.2f} % "
                  f"of positions", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
