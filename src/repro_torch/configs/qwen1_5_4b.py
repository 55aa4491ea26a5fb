"""qwen1.5-4b [dense] — MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B family,
scaled per assignment]. 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.

long_500k: SWA variant (ring-buffer KV cache, window 8192)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B (architecture family; 4B scaling)",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        block_pattern=("attn",),
        long_context="swa",
    )
)
