"""Tree checkpointing to .npz (atomic rename), with a step index, in the
reference's format (``src/repro/ckpt/checkpoint.py``), so that a checkpoint
written by either package loads in the other.

One file per step, ``ckpt_{step:08d}.npz``, written through a temp file in
the same directory and ``os.replace``; then ``LATEST`` holds the step. Each
leaf is one array keyed by its path: dict keys (as ``str``) and list
indices joined by ``/``, as ``jax.tree_util.tree_flatten_with_path`` names
them. A bf16 leaf is stored as its ``uint16`` bit view under
``key + "::bf16"``. ``__treedef__`` describes the tree in UTF-8 bytes and
is never parsed on load: the port writes JSON of each leaf's dtype and
shape, the reference ``str`` of its treedef.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import Pytree, get_device, tree_map, tree_unflatten
from repro_torch.interop import bf16_from_bits, leaf_to_numpy

_SEP = "/"
_BF16 = "::bf16"
_TREEDEF = "__treedef__"


def _paths(tree: Pytree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) in ``tree_leaves`` order; ``None`` subtrees hold no
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _paths(x, prefix + (str(i),))
    elif tree is not None:
        yield _SEP.join(prefix), tree


def save_checkpoint(directory: Union[str, Path], step: int, tree: Pytree
                    ) -> Path:
    """Write ``tree`` (tensors on any device) as step ``step``; returns the
    file's path."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in _paths(tree):
        bf16 = leaf.dtype == torch.bfloat16
        arrays[key + _BF16 if bf16 else key] = leaf_to_numpy(leaf)
    desc = json.dumps(tree_map(
        lambda t: f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}",
        tree))
    final = d / f"ckpt_{step:08d}.npz"
    with tempfile.NamedTemporaryFile(dir=d, suffix=".tmp", delete=False) as f:
        tmp = f.name
        try:
            np.savez(f, **{_TREEDEF: np.frombuffer(desc.encode(), np.uint8)},
                     **arrays)
        except BaseException:
            os.unlink(tmp)
            raise
    os.replace(tmp, final)  # atomic
    (d / "LATEST").write_text(str(step))
    return final


def latest_step(directory: Union[str, Path]) -> Optional[int]:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def load_checkpoint(
    directory: Union[str, Path],
    step: Optional[int] = None,
    like: Optional[Pytree] = None,
    device: Union[str, torch.device, None] = None,
) -> Tuple[int, Pytree]:
    """Load step ``step`` (the latest when ``None``).

    With ``like``, the result mirrors its structure, and each leaf takes the
    dtype and device of ``like``'s leaf at the same path; a shape mismatch
    raises. Without it, a flat dict keyed by path strings is returned, on
    ``device`` (the card unless another device is named), bf16 restored."""
    d = Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {d}")
    flat: Dict[str, torch.Tensor] = {}
    with np.load(d / f"ckpt_{step:08d}.npz") as z:
        for k in z.files:
            if k == _TREEDEF:
                continue
            if k.endswith(_BF16):
                flat[k[:-len(_BF16)]] = bf16_from_bits(z[k])
            else:
                flat[k] = torch.from_numpy(z[k])
    if like is None:
        dev = get_device(device)
        return step, {k: v.to(dev) for k, v in flat.items()}
    leaves = []
    for key, leaf in _paths(like):
        t = flat[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(t.shape)}, expected {tuple(leaf.shape)}")
        leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return step, tree_unflatten(like, leaves)
