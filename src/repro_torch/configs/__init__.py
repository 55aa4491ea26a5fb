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

ARCH_MODULES = ["qwen3_0_6b"]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
