"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048,
4 codebooks (delay interleaving pattern; embeddings summed, one LM head per
codebook).

The audio frontend (EnCodec conv codec / mel frontend) is a STUB per the
assignment carve-out: tokens are precomputed EnCodec codes (B, S, 4).

long_500k: SWA variant."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        source="arXiv:2306.05284 (MusicGen-large)",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        block_pattern=("attn",),
        num_codebooks=4,
        long_context="swa",
    )
)
