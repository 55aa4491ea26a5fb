"""The q/k/v-bias and MoE families of the port against the JAX package's, on
the CPU, at reduced widths: parameter trees, logits, losses and gradients,
and the new leaves across the package boundary and through checkpoints.
The weights are the reference's own initial weights (carried across by
``interop``) with the zero-initialised biases redrawn at random from numpy,
since a zero bias would hide a wrong bias path; tokens are numpy-seeded.
The MoE layer's pieces are held in ``test_torch_moe.py``, the runtime in
``test_torch_families_job.py``.

Configs (``_torch_families.py``): qwen1.5-4b (MHA + bias: reduced with as
many KV heads as heads), qwen2.5-14b (GQA + bias), minitron-8b (GQA, no
bias), qwen2-moe-a2.7b (60 routed experts top-4, 4 shared, bias) and
llama4-scout-17b-a16e (16 experts top-1, 1 shared), each at 2 layers,
d_model 64, vocab 128, with the published expert counts and experts per
token.

Tolerances, and why:
  fp32  logits and gradients: within 1e-4 of the tensor's largest
        magnitude. Without qk_norm, the reference's init gives these
        reduced models sharply peaked attention (scores of tens), which
        amplifies fp32 sums taken in other orders: qwen2.5-14b's logits
        differ by 2.6e-5 of their scale, qwen3's by 6e-7, and by 1.1e-5
        with its qk_norm turned off. An element-wise rtol fails on
        elements near zero for the same reason. Losses: rtol 1e-5.
  bf16  every product rounds to bf16 at places and in orders that
        differ. The logits are held within 2**-4 of their largest
        magnitude (8 bf16 ulps at that scale; ``test_torch_model.py``
        holds qwen3's within 2**-5): with the peaked attention above, each
        package's bf16 logits lie 0.39-1.04 from the fp32 result at a
        scale of 4.3-4.4, and 0.06-0.16 from each other. Losses within
        2e-2.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import load_checkpoint as j_load_checkpoint
from repro.ckpt import save_checkpoint as j_save_checkpoint
from repro.models import model as JM
from repro_torch import configs, interop, tree_leaves
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import ModelConfig
from repro_torch.models import model as M
from _torch_families import (BIAS, MOE, _batch, _cfgs, _close, _grads_port,
                             _params)

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", BIAS + ["minitron-8b"] + MOE)
def test_param_tree_matches_reference(name):
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(name, dtype)
        jp = JM.init(jcfg, jax.random.PRNGKey(0))
        tp = M.init(cfg, torch.Generator().manual_seed(0))
        assert M.n_params(cfg) == JM.n_params(jcfg)
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
        for path, a, b in zip(paths, jax.tree.leaves(jp), tree_leaves(tp),
                              strict=True):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
            if path.endswith(("['bq']", "['bk']", "['bv']")):
                assert not b.any()  # zeros-init, as the reference's
    full = configs.get_config(name)
    assert M.n_params(full) == JM.n_params(jconfigs.get_config(name))


def test_arch_ids_are_the_references_that_the_port_carries():
    assert set(configs.ARCH_IDS) <= set(jconfigs.ARCH_IDS)
    assert [a for a in jconfigs.ARCH_IDS if a in configs.ARCH_IDS] == \
        configs.ARCH_IDS
    # the port's config is the reference's plus port-only fields (Nemotron-
    # H's), each at the default that computes what the reference computes
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    for name in configs.ARCH_IDS + ["example-100m"]:
        port = dataclasses.asdict(configs.get_config(name))
        want = dataclasses.asdict(jconfigs.get_config(name))
        assert {k: port[k] for k in want} == want
        assert {k: v for k, v in port.items() if k not in want} == \
            {k: defaults[k] for k in port if k not in want}


# --------------------------------------------------------------------------
# attention with q/k/v bias, and whole models: forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", BIAS + MOE)
def test_logits_and_loss_match_reference(name, dtype):
    jcfg, cfg = _cfgs(name, dtype)
    _, jp, tp = _params(jcfg)
    jb, tb = _batch()
    jl, _, jaux = JM.forward(jcfg, jp, jb["tokens"])
    tl, _, aux = M.forward(cfg, tp, tb["tokens"])
    jloss = float(JM.loss_fn(jcfg, jp, jb)[0])
    tloss = float(M.loss_fn(cfg, tp, tb)[0])
    if dtype == "float32":
        _close(tl, jl, 1e-4)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        _close(tl, jl, 2.0 ** -4)
        assert abs(tloss - jloss) <= 2e-2
        assert abs(float(aux) - float(jaux)) <= 2e-2
    assert (float(aux) > 0) == (name in MOE)


@pytest.mark.parametrize("name", BIAS + ["minitron-8b"] + MOE)
def test_loss_gradients_match_reference(name):
    """jax.grad of the reference's loss_fn against autograd of the port's,
    through the rematerialised (checkpointed) layers, every leaf: the
    biases and, for MoE, the router and the stacked experts."""
    jcfg, cfg = _cfgs(name)
    assert cfg.remat == "full"
    _, jp, tp = _params(jcfg, seed=1)
    jb, tb = _batch(seed=1)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    loss, g = _grads_port(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), g, strict=True):
        _close(b, a, 1e-4)


# --------------------------------------------------------------------------
# the new leaves across the package boundary and through checkpoints
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen1.5-4b"])
def test_interop_and_checkpoints_carry_the_new_leaves(name, tmp_path):
    jcfg, cfg = _cfgs(name, "bfloat16")
    tree, jp, tp = _params(jcfg, seed=4)
    keys = {jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    for leaf in (["bq", "bk", "bv"] if name in BIAS else
                 ["router", "w_gate", "w_up", "w_down", "shared"]):
        assert any(f"['{leaf}']" in k for k in keys), leaf
    back = interop.to_numpy(tp)
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(back), strict=True):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b)
    # the port's checkpoint in the reference, and the reference's in the port
    save_checkpoint(tmp_path / "port", 1, tp)
    _, jback = j_load_checkpoint(tmp_path / "port", like=jp)
    j_save_checkpoint(tmp_path / "ref", 2, jp)
    _, tback = load_checkpoint(tmp_path / "ref",
                               like=M.init(cfg, torch.Generator()))
    for a, b, c in zip(jax.tree.leaves(jp), jax.tree.leaves(jback),
                       tree_leaves(tback), strict=True):
        assert np.asarray(b).tobytes() == np.asarray(a).tobytes()
        assert c.dtype == torch.bfloat16
        assert interop.leaf_to_numpy(c).tobytes() == \
            np.asarray(a).view(np.uint16).tobytes()
