"""Beyond-paper example: int8-compressed model updates. Parties quantise
updates before upload (4x fewer bytes than fp32 for t_comm, which JIT's
t_upd prediction picks up), and the aggregator fuses them with the
dequantise-accumulate kernel without writing fp32 updates to device memory.

  PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]

Runs the reference's reduced configuration (``examples/serve_quantized.py``)
on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch import Pytree, configs, get_device, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.prediction import UpdatePredictor
from repro_torch.kernels import fuse_quantized, fuse_updates, quantize_update
from repro_torch.models import model as M

WEIGHTS = [0.1, 0.2, 0.3, 0.4]


def compare(cfg: ModelConfig, updates: Sequence[Pytree],
            weights: Sequence[float]) -> Dict[str, object]:
    """Fuse ``updates`` exactly and through int8, and price t_upd for fp32
    and int8 uploads. Returns per-leaf errors and bounds, and the two
    t_upd in seconds; raises if a leaf's error exceeds its bound."""
    exact = fuse_updates(updates, weights)
    qs, ss = zip(*(quantize_update(u) for u in updates))
    fused_q = fuse_quantized(list(qs), list(ss), weights)
    errs = [float((a.to(torch.float32) - b).abs().max())
            for a, b in zip(tree_leaves(exact), tree_leaves(fused_q))]
    # per-leaf error bound: int8 rounding is <= 0.5 quant-step per update
    # and the bf16 inputs carry another ~0.5 step themselves (max_abs =
    # 127*scale and bf16 eps = 2^-8, so 127*scale/256 ~ scale/2); fusion is
    # a convex combination -> bound = 1.0 * sum_k w_k * scale_k
    bounds = [sum(w * float(s_leaf) for w, s_leaf in zip(weights, leaves))
              for leaves in zip(*(tree_leaves(s) for s in ss))]

    # comm-time effect on JIT's schedule
    n_bytes = M.n_params(cfg) * 4
    spec = FLJobSpec(
        job_id="q", model_arch=cfg.name, model_bytes=n_bytes,
        parties={"p0": PartySpec("p0", epoch_time_s=60.0, bw_up=5e6,
                                 bw_down=5e6)},
    )
    t_fp32 = UpdatePredictor(spec).t_upd("p0")
    spec.model_bytes = n_bytes // 4  # int8 + scales
    t_int8 = UpdatePredictor(spec).t_upd("p0")
    for e, b in zip(errs, bounds):
        if not e <= b * 1.05 + 1e-7:
            raise AssertionError(f"int8 fusion error {e} above bound {b}")
    return {"errs": errs, "bounds": bounds, "t_upd_fp32": t_fp32,
            "t_upd_int8": t_int8}


def run(cfg: ModelConfig, *, device: Union[str, torch.device, None] = None,
        seed: int = 0) -> Dict[str, object]:
    """K = 4 perturbed copies of a random model of ``cfg`` (from ``seed``),
    fused with weights 0.1..0.4 through ``compare``."""
    dev = get_device(device)
    base = M.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    updates: List[Pytree] = []
    for k in range(len(WEIGHTS)):
        gen = torch.Generator(device=dev).manual_seed(seed + 1 + k)
        updates.append(tree_map(
            lambda p: p + 0.01 * torch.randn(
                p.shape, generator=gen, device=dev).to(p.dtype),
            base))
    return compare(cfg, updates, WEIGHTS)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    configs.load_all()
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=128, vocab_size=256)
    out = run(cfg, device=args.device)
    print(f"max abs fusion error from int8 updates: {max(out['errs']):.5f} "
          f"(bound {max(out['bounds']):.5f})")
    t_fp32, t_int8 = out["t_upd_fp32"], out["t_upd_int8"]
    print(f"t_upd fp32={t_fp32:.2f}s -> int8={t_int8:.2f}s "
          f"(JIT defers {t_fp32 - t_int8:.2f}s longer)")


if __name__ == "__main__":
    main()
