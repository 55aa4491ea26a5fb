"""Architecture registry (the port carries the configurations its slices
run). ``load_all()`` imports every per-arch module."""
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
    "qwen1_5_4b",
    "qwen3_0_6b",
    "minitron_8b",
    "llama4_scout_17b_a16e",
    "qwen2_5_14b",
    "qwen2_moe_a2_7b",
    "example_100m",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


# the reference's ARCH_IDS, in its order, keeping the architectures the port
# carries (example-100m is not listed there either)
ARCH_IDS = [
    "qwen1.5-4b",
    "qwen3-0.6b",
    "minitron-8b",
    "llama4-scout-17b-a16e",
    "qwen2.5-14b",
    "qwen2-moe-a2.7b",
]
