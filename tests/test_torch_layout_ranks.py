"""``launch.train.run_on_mesh`` on real data: four gloo CPU ranks of a 2 x 2
mesh (``tests/_torch_ranks.py``) train four reduced fp32 configs (dense
qwen3-0.6b, MoE qwen2-moe-a2.7b, SSM mamba2-130m, and qwen2.5-14b with
its sequence parallelism, whose attention splits K/V along the sequence
and distributes the softmax over the blocks) for two AdamW steps,
every tensor a DTensor of which each rank holds its block, from the
reference's initial weights (``interop.to_torch`` of them). The
reference's jitted train step (``repro.launch.steps.build``) runs the
same steps on a concrete 2 x 2 ``jax.sharding.Mesh`` of ``conftest.py``'s
virtual devices, on the same batches (``launch.train.synthetic_batch``
from a generator seeded 1, as ``run_on_mesh`` draws them).

Tolerance: rtol 1e-4, atol 1e-5 on each step's loss, as the repo's fp32
parity tests use: the two partitioners sum the partial products of the
split contractions in other orders.

In the same spawn, one decode step on DTensors (reduced fp32 qwen3-0.6b
with one KV head, so that the cache is split along its keys over the
model axis and the softmax is distributed over the key blocks), after a
plain prefill: its logits against the reference's ``decode_step`` after
its ``prefill`` from the same weights and tokens, rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_ranks import (DECODE_CONFIG, DECODE_SHAPE, TRAIN_CONFIGS,
                          TRAIN_STEPS, run_ranks, train_config, train_shape)
from repro import configs as jconfigs
from repro.configs.base import InputShape as JInputShape
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models.sharding_ctx import activation_sharding
from repro.optim import adamw as jadamw
from repro_torch.configs.base import InputShape
from repro_torch.launch.train import synthetic_batch

jconfigs.load_all()
ARCHS = list(TRAIN_CONFIGS)


def _weights(arch):
    """The reference's init of the reduced config, as numpy."""
    jcfg = jconfigs.get_config(arch).reduced(dtype="float32",
                                            **TRAIN_CONFIGS[arch])
    return jcfg, jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(3)))


def _reference_losses(arch):
    jcfg, params = _weights(arch)
    b, s = train_shape(arch)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    shape = JInputShape("t", s, b, "train")
    fn, _, in_sh, _ = jsteps.build(jcfg, shape, mesh)
    gen = torch.Generator().manual_seed(1)
    cfg = train_config(arch)
    p = jax.tree.map(jnp.asarray, params)
    opt = jadamw(3e-4).init(p)
    losses = []
    with activation_sharding(mesh, jshd.activation_rules(
            mesh, jcfg.sequence_parallel)):
        step = jax.jit(fn, in_shardings=in_sh)
        for _ in range(TRAIN_STEPS):
            batch = synthetic_batch(cfg, InputShape("t", s, b, "train"), gen,
                                    "cpu")
            # each step's inputs laid out as build asks (its outputs come
            # back in the layouts the compiler chose)
            p, opt = jax.device_put(p, in_sh[0]), jax.device_put(opt, in_sh[1])
            p, opt, metrics = step(p, opt, {k: jnp.asarray(v.numpy())
                                           for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
    return params, losses


def _reference_decode():
    """The reference's decode logits after its prefill, from its init of
    the decode config; the weights and tokens, as numpy."""
    name, over = DECODE_CONFIG
    jcfg = jconfigs.get_config(name).reduced(dtype="float32", **over)
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(5)))
    b, s, cap = DECODE_SHAPE
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    token = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    _, cache = JM.prefill(jcfg, params, jnp.asarray(prompt), capacity=cap)
    logits, _ = JM.decode_step(jcfg, params, cache, jnp.asarray(token))
    return ({"params": params, "prompt": prompt, "token": token},
            np.asarray(logits))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 2 x 2 gloo ranks for the four configs and the decode
    step; and the reference's losses and logits."""
    ref, cases = {}, []
    for arch in ARCHS:
        params, ref[arch] = _reference_losses(arch)
        cases.append((arch, "train", {"arch": arch, "params": params}))
    kw, ref["decode"] = _reference_decode()
    cases.append(("decode", "decode", kw))
    out = run_ranks((2, 2), cases, tmp_path_factory.mktemp("layout"),
                    timeout=150.0)
    return out, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_run_on_mesh_losses_match_the_reference(ranks, arch):
    out, ref = ranks
    losses = [out[r][arch] for r in range(4)]
    assert all(l == losses[0] for l in losses)  # every rank reads one loss
    assert len(losses[0]) == TRAIN_STEPS
    np.testing.assert_allclose(losses[0], ref[arch], rtol=1e-4, atol=1e-5)
    assert losses[0][1] != losses[0][0]  # the step moved the weights


def test_decode_on_a_key_split_cache_matches_the_reference(ranks):
    out, ref = ranks
    # the cache (layers, B, slots, KV, D): its batch over the data axis,
    # its slots (keys) over the model axis
    assert out[0]["decode"]["k_split_dims"] == (1, 2)
    for r in range(4):
        np.testing.assert_allclose(out[r]["decode"]["logits"], ref["decode"],
                                   rtol=1e-4, atol=1e-5)
