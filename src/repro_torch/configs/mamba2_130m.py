"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]. 24L
d_model=768, attention-free, d_inner=1536 (expand 2), 24 heads x head_dim 64,
ssm_state=128, conv kernel 4, vocab=50280.

long_500k: NATIVE — O(1) recurrent state."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060 (Mamba-2 130m)",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        block_pattern=("ssm",),
        ssm_state=128,
        ssm_heads=24,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        conv_kernel=4,
        long_context="native",
    )
)
