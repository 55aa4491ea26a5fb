"""qwen2.5-14b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family, 14B
scaling]. 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

long_500k: SWA variant."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B (architecture family; 14B scaling)",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        block_pattern=("attn",),
        long_context="swa",
        sequence_parallel=True,
    )
)
