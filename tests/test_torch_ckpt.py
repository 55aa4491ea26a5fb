"""The port's checkpoints against the JAX package's, on the CPU: the port's
own round trip, and a checkpoint written by either package loaded by the
other, every leaf bit-equal with its dtype kept. Everything here is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as j_load_checkpoint
from repro.ckpt import save_checkpoint as j_save_checkpoint
from repro_torch import interop, tree_leaves
from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint


def _np_tree(seed=0):
    """Nested dicts and a list with bf16, fp32, int32 and 0-d leaves, as
    numpy (bf16 as ml_dtypes, the way JAX hands it over)."""
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((6, 4)).astype(jnp.bfloat16),
        "stage0": {
            "attn": {"wq": rng.standard_normal((2, 4, 3)).astype(np.float32),
                     "q_norm": rng.standard_normal(3).astype(jnp.bfloat16)},
            "ids": rng.integers(-5, 5, size=(5,), dtype=np.int32),
        },
        "layers": [rng.standard_normal(2).astype(np.float32),
                   {"b": rng.standard_normal((1, 2)).astype(jnp.bfloat16)}],
        "step": np.asarray(7, np.int32),
        "lr": np.asarray(0.25, np.float32),
    }


def _torch_tree(seed=0):
    return interop.to_torch(_np_tree(seed), "cpu")


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return interop.leaf_to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _assert_same(got, want):
    assert [tuple(l.shape) for l in tree_leaves(got)] == \
        [tuple(l.shape) for l in tree_leaves(want)]
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert g.dtype == w.dtype and g.device == w.device
        assert _bits(g) == _bits(w)


def test_round_trip(tmp_path):
    tree = _torch_tree()
    path = save_checkpoint(tmp_path, 3, tree)
    assert path == tmp_path / "ckpt_00000003.npz"
    assert latest_step(tmp_path) == 3
    step, back = load_checkpoint(tmp_path, like=_torch_tree(seed=1))
    assert step == 3
    _assert_same(back, tree)
    # without ``like``: a flat dict keyed by path strings, bf16 restored
    _, flat = load_checkpoint(tmp_path, device="cpu")
    assert sorted(flat) == sorted([
        "embed", "layers/0", "layers/1/b", "lr", "stage0/attn/q_norm",
        "stage0/attn/wq", "stage0/ids", "step"])
    assert flat["embed"].dtype == torch.bfloat16
    assert _bits(flat["layers/1/b"]) == _bits(tree["layers"][1]["b"])
    assert flat["step"].shape == () and int(flat["step"]) == 7
    assert not list(tmp_path.glob("*.tmp"))


def test_latest_advances_and_a_given_step_loads(tmp_path):
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path, device="cpu")
    trees = [_torch_tree(seed) for seed in range(3)]
    for step, tree in zip((0, 5, 12), trees):
        save_checkpoint(tmp_path, step, tree)
        assert latest_step(tmp_path) == step
    like = _torch_tree(seed=9)
    step, back = load_checkpoint(tmp_path, like=like)
    assert step == 12
    _assert_same(back, trees[2])
    step, back = load_checkpoint(tmp_path, step=5, like=like)
    assert step == 5
    _assert_same(back, trees[1])


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _torch_tree())
    like = _torch_tree()
    like["stage0"]["attn"]["wq"] = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="stage0/attn/wq"):
        load_checkpoint(tmp_path, like=like)


def test_like_sets_dtype(tmp_path):
    """Each leaf takes ``like``'s dtype, as the reference's
    ``jnp.asarray(arr, dtype=leaf.dtype)`` does."""
    save_checkpoint(tmp_path, 1, {"w": torch.tensor([1.5, -2.0])})
    _, back = load_checkpoint(
        tmp_path, like={"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert back["w"].tolist() == [1.5, -2.0]


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jtree = jax.tree.map(jnp.asarray, _np_tree())
    j_save_checkpoint(tmp_path, 4, jtree)
    step, back = load_checkpoint(tmp_path, like=_torch_tree(seed=1))
    assert step == 4
    _assert_same(back, _torch_tree())


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    save_checkpoint(tmp_path, 2, _torch_tree())
    like = jax.tree.map(jnp.asarray, _np_tree(seed=1))
    step, back = j_load_checkpoint(tmp_path, like=like)
    assert step == 2
    want = jax.tree.map(jnp.asarray, _np_tree())
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    # and the reference's flat load sees the same keys as the port's
    _, jflat = j_load_checkpoint(tmp_path)
    _, flat = load_checkpoint(tmp_path, device="cpu")
    assert sorted(jflat) == sorted(flat)


def test_flat_load_needs_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    save_checkpoint(tmp_path, 0, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(tmp_path)
