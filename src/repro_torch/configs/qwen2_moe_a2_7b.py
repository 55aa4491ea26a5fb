"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 24L d_model=2048 16H (kv=16) d_ff=1408 per
routed expert (shared expert = 4x1408), vocab=151936.

long_500k: SWA variant."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151_936,
        qkv_bias=True,
        block_pattern=("moe",),
        num_experts=60,
        num_experts_per_tok=4,
        num_shared_experts=4,
        long_context="swa",
    )
)
