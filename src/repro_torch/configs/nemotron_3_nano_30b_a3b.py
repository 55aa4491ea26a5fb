"""nemotron-3-nano-30b-a3b [hybrid] — Mamba-2, MoE and attention blocks in
Nemotron-H's published 52-block pattern
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]. d_model=2688; 23 Mamba-2
mixers (M: 64 heads x 64, d_inner 4096, 8 B/C groups of state 128, conv 4
with bias, chunk 128), 23 MoE blocks (E: 128 relu² experts of 1856, top-6
by sigmoid scores plus a correction bias, gates normalised and scaled by
2.5, one relu² shared expert of 3712), 6 attention blocks (*: GQA 32 / 2
heads of 128, no bias, no qk_norm, no rotary embeddings); each block is
x + mixer(RMSNorm(x)); untied head, vocab 131072, eps 1e-5. 31,577,940,288
parameters.

Not in ``ARCH_IDS``: the JAX package has no such model."""
from repro_torch.configs.base import ModelConfig, register

#: the published hybrid_override_pattern
PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
BLOCKS = {"M": "ssm", "E": "moe_only", "*": "attn_only"}

CONFIG = register(
    ModelConfig(
        name="nemotron-3-nano-30b-a3b",
        family="hybrid",
        source="hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
        num_layers=len(PATTERN),
        d_model=2688,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=1856,
        vocab_size=131_072,
        rotary=False,
        block_pattern=tuple(BLOCKS[c] for c in PATTERN),
        num_experts=128,
        num_experts_per_tok=6,
        num_shared_experts=1,
        router_aux_weight=0.0,
        router="sigmoid",
        routed_scale=2.5,
        expert_act="relu2",
        shared_d_ff=3712,
        dropless=True,
        ssm_state=128,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_chunk=128,
        ssm_expand=0,
        ssm_groups=8,
        conv_kernel=4,
        ssm_conv_bias=True,
        norm_eps=1e-5,
        embed_scale=False,
    )
)
