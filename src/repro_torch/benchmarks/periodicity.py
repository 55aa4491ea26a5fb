"""Paper Figs. 3 & 4: the two properties JIT prediction rests on, measured
with REAL PyTorch training (not simulated), on the card unless
``device="cpu"`` is given:

  Fig. 3 — periodicity: minibatch & epoch times are ~constant across epochs
           (coefficient of variation reported).
  Fig. 4 — linearity: minibatch time vs batch size, epoch time vs dataset
           size (least-squares R^2 reported).

The model and sizes are the JAX package's ``benchmarks/periodicity.py``:
qwen3-0.6b reduced to 2 layers, d_model 128, vocab 256, sequences of 64,
AdamW at 1e-3. Each step is timed on the host clock up to
``torch.cuda.synchronize()`` on the card (the reference blocks on the
params), so a time covers the step's device work, not its enqueue.

  PYTHONPATH=src python -m repro_torch.benchmarks.periodicity [--device cpu]

CSV: metric,x,seconds  plus summary lines periodicity_cv,... linearity_r2,...
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, get_device
from repro_torch.data import Loader, SyntheticLM, SyntheticLMConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw

configs.load_all()


def _setup(batch_size: int, n_sequences: int, device, seed=0):
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=128, vocab_size=256
    )
    data_cfg = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=64)
    lm = SyntheticLM(data_cfg, seed=seed)
    ds = lm.make_dataset(np.full(10, 0.1), n_sequences, seed=seed)
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(seed))
    return cfg, ds, opt, step, params


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(device) -> None:
    """Wait for the step's work on the card (the CPU's is done when the
    call returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_epochs(n_epochs=5, batch_size=16, n_sequences=128, device=None):
    device = get_device(device)
    cfg, ds, opt, step, params = _setup(batch_size, n_sequences, device)
    loader = Loader(ds, batch_size)
    opt_state = opt.init(params)
    mb_times, ep_times = [], []
    for ep in range(n_epochs + 1):  # first epoch = warmup
        t_ep = time.perf_counter()
        for batch in loader.epoch():
            b = _on(batch, device)
            t0 = time.perf_counter()
            params, opt_state, _ = step(params, opt_state, b)
            _sync(device)
            if ep > 0:
                mb_times.append(time.perf_counter() - t0)
        if ep > 0:
            ep_times.append(time.perf_counter() - t_ep)
    return np.asarray(mb_times), np.asarray(ep_times)


def measure_linearity_batch(batch_sizes=(4, 8, 16, 32), device=None):
    device = get_device(device)
    out = []
    for bs in batch_sizes:
        cfg, ds, opt, step, params = _setup(bs, 64, device)
        loader = Loader(ds, bs)
        opt_state = opt.init(params)
        batch = _on(next(iter(loader.epoch())), device)
        step(params, opt_state, batch)  # warmup
        _sync(device)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            p2, o2, _ = step(params, opt_state, batch)
            _sync(device)
            ts.append(time.perf_counter() - t0)
        out.append((bs, float(np.median(ts))))
    return out


def measure_linearity_dataset(sizes=(32, 64, 128, 256), batch_size=16,
                              device=None):
    out = []
    for n in sizes:
        mb, ep = measure_epochs(n_epochs=1, batch_size=batch_size,
                                n_sequences=n, device=device)
        out.append((n, float(ep[0])))
    return out


def r2(xs, ys):
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    a, b = np.polyfit(xs, ys, 1)
    pred = a * xs + b
    ss_res = ((ys - pred) ** 2).sum()
    ss_tot = ((ys - ys.mean()) ** 2).sum()
    return 1.0 - ss_res / max(ss_tot, 1e-12)


def main(argv=None):
    """Print the CSV and return the four summary numbers."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    print("metric,x,seconds")
    mb, ep = measure_epochs(device=device)
    for i, t in enumerate(ep):
        print(f"epoch_time,{i},{t:.4f}")
    cv_mb = float(mb.std() / mb.mean())
    cv_ep = float(ep.std() / ep.mean())
    lin_b = measure_linearity_batch(device=device)
    for bs, t in lin_b:
        print(f"minibatch_vs_batchsize,{bs},{t:.5f}")
    lin_d = measure_linearity_dataset(device=device)
    for n, t in lin_d:
        print(f"epoch_vs_datasetsize,{n},{t:.4f}")
    out = {"cv_minibatch": cv_mb, "cv_epoch": cv_ep,
           "r2_batchsize": float(r2(*zip(*lin_b))),
           "r2_datasetsize": float(r2(*zip(*lin_d)))}
    print(f"periodicity_cv_minibatch,,{cv_mb:.4f}")
    print(f"periodicity_cv_epoch,,{cv_ep:.4f}")
    print(f"linearity_r2_batchsize,,{out['r2_batchsize']:.4f}")
    print(f"linearity_r2_datasetsize,,{out['r2_datasetsize']:.4f}")
    return out


if __name__ == "__main__":
    main()
