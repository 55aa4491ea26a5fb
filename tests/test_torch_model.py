"""The port's model, loss and party step against the JAX package's, on the
CPU, from the reference's own initial weights (``M.init`` with a PRNGKey,
carried across by ``interop``) and numpy-seeded tokens. Config: qwen3-0.6b
reduced as in ``tests/test_fl_integration.py`` (2 layers, d_model 64,
vocab 128), in fp32 and in its default bf16.

Tolerances, and why:
  fp32  logits, loss, gradients and the updated parameters agree within
        rtol 1e-4 / atol 1e-5 (matrix products summed in another order).
  bf16  every matrix product rounds its output to bf16 in both packages, at
        places and in orders that differ, so a value may move by a few bf16
        ulps: logits within 2**-5 of the largest |logit| (4 ulps at that
        scale), gradients within 2**-5 of the leaf's largest |g|, the loss
        within 2e-2. After one SGD step a parameter may round to the
        neighbouring bf16 value: within one ulp of its magnitude (2**-7 of
        it) plus lr times the gradient bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.fl.party import Party as JParty
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch import configs, interop, tree_leaves
from repro_torch.fl.party import Party
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as M

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()
LR = 0.05
BF16_ULP = 2.0 ** -7


def _cfgs(dtype):
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype=dtype)
    return (jconfigs.get_config("qwen3-0.6b").reduced(**kw),
            configs.get_config("qwen3-0.6b").reduced(**kw))


def _setup(dtype, seed=0):
    jcfg, cfg = _cfgs(dtype)
    jp = JM.init(jcfg, jax.random.PRNGKey(seed))
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    data = {"tokens": rng.integers(0, 128, (4, 32)).astype(np.int32),
            "labels": rng.integers(0, 128, (4, 32)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in data.items()}
    return jcfg, cfg, jp, tp, data, jb, tb


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def test_param_tree_matches_reference():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype)
        jp = JM.init(jcfg, jax.random.PRNGKey(0))
        tp = M.init(cfg, torch.Generator().manual_seed(0))
        assert M.n_params(cfg) == JM.n_params(jcfg)
        assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    # and weights cross the boundary bit for bit, both ways
    jp = JM.init(_cfgs("bfloat16")[0], jax.random.PRNGKey(1))
    back = interop.to_numpy(interop.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b)


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 4, 64), dtype=np.float32)
    scale = rng.standard_normal(64, dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)
    np.testing.assert_allclose(
        _f32(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        _f32(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _f32(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        _f32(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    w = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in
         [("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64))]}
    h = x.reshape(2, 16, 256)[..., :64]
    np.testing.assert_allclose(
        _f32(layers.mlp_apply({k: torch.from_numpy(v) for k, v in w.items()},
                              torch.from_numpy(h))),
        _f32(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(h))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("q_chunk", [8, 256])
def test_causal_attention_matches_reference(q_chunk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)
    got = attn.chunked_causal_attn(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(pos), q_chunk=q_chunk)
    want = jattn.chunked_causal_attn(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(pos), jnp.asarray(pos),
                                     q_chunk=q_chunk)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_reference(dtype):
    jcfg, cfg, jp, tp, _, jb, tb = _setup(dtype)
    jl, _, _ = JM.forward(jcfg, jp, jb["tokens"])
    tl, aux = M.forward(cfg, tp, tb["tokens"])
    assert tl.dtype == torch.float32 and tuple(tl.shape) == tuple(jl.shape)
    assert float(aux) == 0.0
    jloss = float(JM.loss_fn(jcfg, jp, jb)[0])
    tloss = float(M.loss_fn(cfg, tp, tb)[0])
    if dtype == "float32":
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    else:
        bound = 2.0 ** -5 * np.abs(_f32(jl)).max()
        assert np.abs(_f32(tl) - _f32(jl)).max() <= bound
        assert abs(tloss - jloss) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_party_step_matches_reference(dtype, algorithm):
    """The loss gradient (what a FedSGD party sends) and one local step
    (FedAvg, or FedProx with mu=1 from a moved model), each against the
    reference Party's compiled function."""
    jcfg, cfg, jp, tp, data, jb, tb = _setup(dtype, seed=2)
    kw = dict(algorithm=algorithm, batch_size=4, lr=LR, prox_mu=1.0)
    jparty = JParty("p", jcfg, data, **kw)
    party = Party("p", cfg, data, device="cpu", **kw)
    # start from parameters away from the global model, so the proximal
    # term has a gradient
    rng = np.random.default_rng(9)
    noise = [rng.standard_normal(np.shape(a), dtype=np.float32) * 0.01
             for a in jax.tree.leaves(jp)]
    jstart = jax.tree.unflatten(
        jax.tree.structure(jp),
        [(a.astype(jnp.float32) + n).astype(a.dtype)
         for a, n in zip(jax.tree.leaves(jp), noise)])
    tstart = interop.to_torch(jax.tree.map(np.asarray, jstart), "cpu")
    jgrads, _ = jparty._grad_accum(jstart, jb)
    tgrads, _ = party._grad_step(tstart, tb)
    gbound = []
    for a, b in zip(jax.tree.leaves(jgrads), tree_leaves(tgrads)):
        if dtype == "float32":
            np.testing.assert_allclose(_f32(b), _f32(a), rtol=1e-4, atol=1e-5)
            gbound.append(0.0)
        else:
            gbound.append(2.0 ** -5 * np.abs(_f32(a)).max())
            assert np.abs(_f32(b) - _f32(a)).max() <= gbound[-1]
    jnew, _, jloss = jparty._step(jstart, jparty._opt.init(jstart), jb, jp)
    tnew, _, tloss = party._step(tstart, party._opt.init(tstart), tb, tp)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)
    for a, b, gb in zip(jax.tree.leaves(jnew), tree_leaves(tnew), gbound):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        if dtype == "float32":
            np.testing.assert_allclose(_f32(b), _f32(a), rtol=1e-4, atol=1e-5)
        else:
            bound = (BF16_ULP * np.maximum(np.abs(_f32(a)), np.abs(_f32(b)))
                     + LR * gb)
            assert np.all(np.abs(_f32(b) - _f32(a)) <= bound)
    # the step is out of place: the starting tree is untouched
    for a, b in zip(tree_leaves(tstart), tree_leaves(
            interop.to_torch(jax.tree.map(np.asarray, jstart), "cpu"))):
        assert torch.equal(a, b)


def test_remat_changes_nothing():
    _, cfg, _, tp, _, _, tb = _setup("float32")
    party = Party("p", cfg, {"tokens": np.zeros((1, 2), np.int32),
                             "labels": np.zeros((1, 2), np.int32)},
                  device="cpu")
    g_remat, _ = party._grad_step(tp, tb)
    party.cfg = dataclasses.replace(cfg, remat="none")
    g_plain, _ = party._grad_step(tp, tb)
    for a, b in zip(tree_leaves(g_remat), tree_leaves(g_plain)):
        assert torch.equal(a, b)
    # the caller's parameters are not turned into autograd leaves
    assert not any(t.requires_grad for t in tree_leaves(tp))
