"""Model / run configuration dataclasses and the architecture registry."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation for the architecture numbers
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # rotary embeddings on q and k; Nemotron-H's attention applies none
    rotary: bool = True
    sliding_window: Optional[int] = None  # window for "lattn" blocks
    # window used when a full-attention arch runs long_500k as the SWA variant
    swa_window: int = 8192

    # --- block pattern (repeated; remainder handled as a trailing stage) ---
    # entries: attn | lattn | xattn | moe | rglru | ssm | moe_only |
    # attn_only (the last two: one mixer after its norm, no MLP)
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # softmax | sigmoid: sigmoid scores, the top-k chosen on the scores plus
    # a per-expert ``e_score_correction_bias`` leaf (the choice only), the
    # gates the chosen scores over their sum
    router: str = "softmax"
    routed_scale: float = 1.0  # every gate times this
    expert_act: str = "swiglu"  # swiglu | relu2 (non-gated relu(x)^2 MLP)
    shared_d_ff: int = 0  # the shared experts' width; 0: d_ff x num_shared
    # the experts this layer holds, [expert_first, expert_first +
    # experts_held) of num_experts (0: all); the router keeps all of them
    expert_first: int = 0
    experts_held: int = 0
    dropless: bool = False  # a capacity of every position: nothing dropped

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    ssm_expand: int = 2  # d_inner = ssm_expand x d_model; 0: heads x head_dim
    ssm_groups: int = 1  # B/C groups; head h reads group h // (heads / groups)
    conv_kernel: int = 4
    ssm_conv_bias: bool = False

    # --- RG-LRU (Griffin / recurrentgemma) ----------------------------------
    rnn_width: int = 0
    rglru_c: float = 8.0

    # --- VLM ---------------------------------------------------------------
    num_image_tokens: int = 0

    # --- audio -------------------------------------------------------------
    num_codebooks: int = 0

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-6
    # embeddings times sqrt(d_model); None: for the hybrid family
    # (recurrentgemma's convention)
    embed_scale: Optional[bool] = None
    dtype: str = "bfloat16"
    # how this arch supports long_500k: native | swa
    long_context: str = "swa"
    # remat policy for training: none | full
    remat: str = "full"
    # fully unroll the layer scan (dry-run only: makes XLA cost_analysis
    # count every layer instead of the scan body once)
    scan_unroll: bool = False
    # shard the residual stream's sequence dim over the model axis (Megatron
    # sequence parallelism); needed for the biggest archs to fit activations.
    sequence_parallel: bool = False

    @property
    def d_inner(self) -> int:  # SSM inner width
        if self.ssm_expand:
            return self.ssm_expand * self.d_model
        return self.ssm_heads * self.ssm_head_dim

    @property
    def n_experts_held(self) -> int:
        """The experts whose weights a MoE layer holds."""
        return self.experts_held or self.num_experts

    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose num_layers into (pattern, repeats) scan stages.

        Full repetitions of ``block_pattern`` form one scanned stage; a
        non-empty remainder forms a second stage with a truncated pattern.
        """
        p = len(self.block_pattern)
        reps, rem = divmod(self.num_layers, p)
        out = []
        if reps:
            out.append((tuple(self.block_pattern), reps))
        if rem:
            out.append((tuple(self.block_pattern[:rem]), 1))
        return tuple(out)

    def block_types(self) -> Tuple[str, ...]:
        """Flat per-layer block types, length num_layers."""
        out = []
        for pat, reps in self.stages():
            out.extend(list(pat) * reps)
        assert len(out) == self.num_layers
        return tuple(out)

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        kw: Dict = dict(
            num_layers=len(self.block_pattern),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            name=self.name + "-reduced",
        )
        if self.num_experts:
            kw["num_experts"] = min(self.num_experts, 4)
            kw["num_experts_per_tok"] = min(self.num_experts_per_tok, 2)
            kw["num_shared_experts"] = min(self.num_shared_experts, 1)
            if self.shared_d_ff:
                kw["shared_d_ff"] = 2 * kw["d_ff"]
            if self.experts_held:  # a share of half the experts
                kw["expert_first"] = 0
                kw["experts_held"] = kw["num_experts"] // 2
        if self.ssm_heads:
            kw["ssm_heads"] = 4
            kw["ssm_head_dim"] = (self.ssm_expand * kw["d_model"] // 4
                                  if self.ssm_expand else 32)
            kw["ssm_state"] = 32
            kw["ssm_chunk"] = 16
            kw["ssm_groups"] = min(self.ssm_groups, 2)
        if self.rnn_width:
            kw["rnn_width"] = min(self.d_model, 256)
        if self.sliding_window:
            kw["sliding_window"] = 64
        if self.num_image_tokens:
            kw["num_image_tokens"] = 16
        kw["swa_window"] = 64
        kw["sequence_parallel"] = False
        kw.update(over)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # populate registry lazily
        from repro_torch import configs as _c  # noqa: F401

        _c.load_all()
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    from repro_torch import configs as _c

    _c.load_all()
    return dict(_REGISTRY)
