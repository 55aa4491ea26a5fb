"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention pattern [arXiv:2402.19427]. 38L d_model=4096 16H (GQA kv=1, i.e.
MQA) d_ff=12288 vocab=256000, local window 2048, rnn width 4096.

long_500k: NATIVE — RG-LRU state is O(1), local attention cache is
O(window)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="arXiv:2402.19427 (Griffin / RecurrentGemma-9B)",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        sliding_window=2048,
        block_pattern=("rglru", "rglru", "lattn"),
        rnn_width=4096,
        rope_theta=10_000.0,
        long_context="native",
        sequence_parallel=True,
    )
)
