"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E]. 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 per expert, vocab=202048.

long_500k: SWA variant (Llama-4 itself uses chunked local attention)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        rope_theta=500_000.0,
        block_pattern=("moe",),
        num_experts=16,
        num_experts_per_tok=1,
        num_shared_experts=1,
        long_context="swa",
        sequence_parallel=True,
    )
)
