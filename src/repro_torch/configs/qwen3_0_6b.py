"""qwen3-0.6b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family]. 28L
d_model=1024 16H (kv=8) head_dim=128 d_ff=3072 vocab=151936.

long_500k: SWA variant."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        source="hf:Qwen/Qwen3-8B (architecture family; 0.6B config)",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        block_pattern=("attn",),
        long_context="swa",
    )
)
