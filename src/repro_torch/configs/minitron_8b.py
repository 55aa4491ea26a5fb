"""minitron-8b [dense] — pruned Nemotron [arXiv:2407.14679]. 32L d_model=4096
32H (GQA kv=8) d_ff=16384 vocab=256000.

long_500k: SWA variant."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-8b",
        family="dense",
        source="arXiv:2407.14679 (Minitron-8B)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256_000,
        rope_theta=500_000.0,
        block_pattern=("attn",),
        long_context="swa",
    )
)
