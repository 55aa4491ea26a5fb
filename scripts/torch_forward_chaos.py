"""How far one forward of the port moves when every weight is scaled by
1 + 1e-7, from the seeded initialisation and from ``chip_smoke.conditioned``
weights, by config and depth (fp32, d_model 512, 8 / 2 heads, vocab 4,096,
2 sequences of 256 tokens). Also the forward over the same tokens padded to
512, which must not move the first 256 positions (the forward is causal).

    PYTHONPATH=src python scripts/torch_forward_chaos.py [--device cpu]

Without qk_norm the seeded initialisation peaks the attention (its fan-in
is taken from the heads axis, ROADMAP Queue 3), and the forward is then
chaotic: rounding alone parts two computations of the same logits, so a
decode step and a teacher-forced forward of such a model disagree, in fp32
too, without a fault in either. About 1 minute and 4 GB on the CPU.
"""
import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (for ``conditioned``)
from repro_torch import configs, tree_map  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = args.device
    configs.load_all()
    for name in ("qwen2.5-14b", "qwen3-0.6b"):
        for layers in (2, 8, 24):
            cfg = configs.get_config(name).reduced(
                num_layers=layers, d_model=512, num_heads=8, num_kv_heads=2,
                vocab_size=4096, dtype="float32")
            seeded = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
            cond = chip_smoke.conditioned(torch, seeded,
                                          torch.Generator().manual_seed(0))
            toks = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(1))
            moved = {}
            with torch.no_grad():
                for tag, p in (("seeded", seeded), ("conditioned", cond)):
                    a = M.forward(cfg, p, toks)[0]
                    b = M.forward(cfg, tree_map(lambda x: x * (1 + 1e-7), p),
                                  toks)[0]
                    moved[tag] = float((a - b).abs().max())
                    if tag == "seeded":
                        c = M.forward(cfg, p, torch.nn.functional.pad(
                            toks, (0, 256)))[0][:, :256]
                        padded = float((a - c).abs().max())
            print(f"{name} {layers} layers: weights x (1 + 1e-7) move the "
                  f"logits by {moved['seeded']:.3e} (seeded), "
                  f"{moved['conditioned']:.3e} (conditioned); padding to "
                  f"512 moves them by {padded:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
