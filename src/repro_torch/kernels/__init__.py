"""Fusion kernels: hand-written CUDA for the card (``csrc/``), their plain
PyTorch versions (``ref.py``) for the CPU, and the tree-level wrappers."""
from repro_torch.kernels.ops import (  # noqa: F401
    accumulate,
    accumulate_batch,
    fuse_quantized,
    fuse_updates,
    quantize_update,
)
