"""example-100m — in-house ~100M-parameter dense config used by the
end-to-end federated-training example (small vocab keeps CPU steps fast)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="example-100m",
        family="dense",
        source="repro (example config)",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=8192,
        block_pattern=("attn",),
        long_context="swa",
    )
)
