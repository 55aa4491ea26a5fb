"""Fusion kernels: hand-written CUDA for the card (``csrc/``), their plain
PyTorch versions (``ref.py``) for the CPU, and the tree-level wrappers."""
from repro_torch.kernels.ops import accumulate, fuse_updates  # noqa: F401
