"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision, 90B scaling]. 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.

The vision frontend (ViT encoder + projector) is a STUB per the assignment
carve-out: input_specs() provides projected patch embeddings
(B, 1601, d_model). Only the language decoder is implemented/trained.

long_500k: SWA variant for self-attn layers; cross-attn reads the fixed
O(num_patches) image cache."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision (90B scaling)",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128_256,
        rope_theta=500_000.0,
        block_pattern=("attn", "attn", "attn", "attn", "xattn"),
        num_image_tokens=1601,
        long_context="swa",
        sequence_parallel=True,
    )
)
