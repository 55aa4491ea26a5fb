"""Architecture registry. ``load_all()`` imports every per-arch module."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
    register,
)

ARCH_MODULES = [
    "recurrentgemma_9b",
    "qwen1_5_4b",
    "qwen3_0_6b",
    "llama_3_2_vision_90b",
    "mamba2_130m",
    "musicgen_large",
    "minitron_8b",
    "llama4_scout_17b_a16e",
    "qwen2_5_14b",
    "qwen2_moe_a2_7b",
    "example_100m",
    "nemotron_3_nano_30b_a3b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


ARCH_IDS = [
    "recurrentgemma-9b",
    "qwen1.5-4b",
    "qwen3-0.6b",
    "llama-3.2-vision-90b",
    "mamba2-130m",
    "musicgen-large",
    "minitron-8b",
    "llama4-scout-17b-a16e",
    "qwen2.5-14b",
    "qwen2-moe-a2.7b",
]
