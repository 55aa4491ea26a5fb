"""The host's share of the port's eager steps: what the model code's layout
helpers (``models/sharding_ctx.py``: ``contract``, ``write``, ``write_slot``,
``head_local``, ``lookup``, ``as_layout``) cost on plain tensors, and the
decode and train steps they sit in, so that two trees of the port can be
compared on one machine.

  # each helper's host time a call on plain tensors, beside the op it wraps
  PYTHONPATH=src python scripts/torch_step_host_cost.py --helpers

  # decode steps (synchronised, and the host's enqueue alone) and AdamW
  # train steps at full width and depth on the card; one JSON line
  PYTHONPATH=src python scripts/torch_step_host_cost.py --steps \
      --arch qwen3-0.6b mamba2-130m --label tree-a

``--steps`` uses only what every tree of the port since the launchers has
(``model.init``, ``launch.serve.generate``, ``launch.steps``), so it runs on
an older tree too: point ``PYTHONPATH`` at that tree's ``src``. ``--device
cpu --reduced`` runs both on the CPU at a reduced size. Times are the
host's clock; the decode prompt is 1,024 tokens, as in ``chip_smoke.py``
phases 11-12.
"""
import argparse
import json
import statistics
import time

import torch

# (arch, batch) as chip_smoke.py serves them
BATCH = {"qwen3-0.6b": 8, "qwen2.5-14b": 4, "qwen2-moe-a2.7b": 4,
         "mamba2-130m": 8, "recurrentgemma-9b": 4, "musicgen-large": 4}


def _per_call(fn, n: int, sync) -> float:
    """Host microseconds a call of ``fn``, over ``n`` calls after a warm-up."""
    for _ in range(20):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    sync()
    return t / n * 1e6


def helpers(device: torch.device, n: int) -> dict:
    """Each helper against the plain op it stands for, on small plain
    tensors (the host's cost dominates): microseconds a call, alternated
    three times, and the median of each."""
    from repro_torch.models import sharding_ctx as sc

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    g = torch.Generator(device="cpu").manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(device)

    x, wq = r(2, 4, 16), r(16, 4, 8)
    w2, cache, k1 = r(16, 32), r(2, 8, 4, 8), r(2, 1, 4, 8)
    slot = torch.tensor([3], device=device)
    tok = torch.randint(0, 32, (2, 4), generator=g).to(device)
    table = r(32, 16)
    a = r(2, 4, 16)
    pairs = {
        "contract einsum": (
            lambda: sc.contract("bsd,dhk->bshk", x, wq),
            lambda: torch.einsum("bsd,dhk->bshk", x, wq)),
        "contract matmul": (
            lambda: sc.contract("...d,df->...f", x, w2, torch.matmul),
            lambda: torch.matmul(x, w2)),
        "write": (lambda: sc.write(cache[:, :1], k1),
                  lambda: cache[:, :1].copy_(k1)),
        "write_slot": (lambda: sc.write_slot(cache, 1, slot, k1),
                       lambda: cache.index_copy_(1, slot, k1)),
        "head_local": (
            lambda: sc.head_local(torch.neg, (4,), ((0, 2),), ((0, 2),), a),
            lambda: torch.neg(a)),
        "lookup": (lambda: sc.lookup(tok, table),
                   lambda: torch.nn.functional.embedding(tok, table)),
        "as_layout": (lambda: sc.as_layout(x, x), lambda: x),
    }
    out = {}
    for name, (wrapped, plain) in pairs.items():
        w_us, p_us = [], []
        for _ in range(3):
            w_us.append(_per_call(wrapped, n, sync))
            p_us.append(_per_call(plain, n, sync))
        out[name] = {"helper_us": statistics.median(w_us),
                     "plain_us": statistics.median(p_us),
                     "added_us": statistics.median(w_us)
                     - statistics.median(p_us)}
    return out


def decode(cfg, batch: int, prompt_len: int, tokens: int,
           device: torch.device) -> dict:
    """``generate`` twice from the same weights and prompt: synchronised
    after each step (the step's time), then unsynchronised (the host's
    enqueue). Medians over steps 9 on, in ms."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init(cfg, gen)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks else ())
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=device, dtype=torch.int32)
    cap = prompt_len + tokens
    row = {"config": cfg.name, "layers": cfg.num_layers, "batch": batch}
    for key, timed in (("decode_ms", True), ("enqueue_ms", False)):
        g = serve.generate(cfg, params, prompt, tokens, cap, timed=timed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if not g.finite:
            raise FloatingPointError(f"{cfg.name}: non-finite logits")
        steps = [s * 1e3 for s in g.step_s[8:]]
        row[key] = statistics.median(steps)
        row[key + "_min"], row[key + "_max"] = min(steps), max(steps)
        if timed:
            row["prefill_ms"] = g.prefill_s * 1e3
        del g
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def train(cfg, batch: int, seq: int, n: int, device: torch.device) -> dict:
    """``n`` AdamW steps of ``launch.steps.make_train_step`` from
    ``model.init`` (seed 0), each synchronised by reading its loss: the
    median of steps 2 on, in ms."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    step = steps_mod.make_train_step(cfg)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(0))
    opt_state = adamw(3e-4).init(params)
    gen = torch.Generator(device=device).manual_seed(1)
    times, losses = [], []
    for _ in range(n):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                               device=device, dtype=torch.int32)
        b = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    del params, opt_state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": batch, "seq": seq,
            "step_ms": statistics.median(times[1:]), "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--helpers", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--arch", nargs="*", default=["qwen3-0.6b"])
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    from repro_torch import configs, get_device

    dev = get_device(args.device)
    out = {"label": args.label, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    if args.helpers:
        out["helpers"] = helpers(dev, args.calls)
    if args.steps:
        out["decode"] = []
        for arch in args.arch:
            cfg = configs.get_config(arch)
            cfg = cfg.reduced() if args.reduced else cfg
            out["decode"].append(decode(cfg, BATCH.get(arch, 4),
                                        args.prompt_len, args.tokens, dev))
        cfg = configs.get_config("qwen3-0.6b")
        out["train"] = train(cfg.reduced() if args.reduced else cfg, 8, 128,
                             5, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
