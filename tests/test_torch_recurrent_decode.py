"""Specs, caches, prefill and decode of the four families that carry state
other than a KV cache: mamba2-130m (SSM state and conv tails),
recurrentgemma-9b (RG-LRU state and conv tail beside a windowed KV cache),
musicgen-large (codebook tokens) and llama-3.2-vision-90b (cached image
K/V), against the JAX package's, on the CPU, reduced (d_model 64, vocab
128; 5 layers for the 5- and 3-block patterns, else 2).

Tolerances: spec trees and the zero caches ``==``; prefill and decode
logits and cache contents in fp32 within rtol 1e-4 / atol 1e-5, from
``_params(condition=True)`` weights (the attention configs have no qk_norm:
see ``test_torch_xattn_audio.py``); the port's decode against its own full
forward at the reference's ``test_decode_matches_full_forward`` bound, rtol
/ atol 2e-2, from the seeded weights as the reference's test has them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs, tree_leaves
from repro_torch.models import model as M

from _torch_families import _batch_for, _cfgs, _params

torch.set_num_threads(1)

FAMILIES = ["mamba2-130m", "recurrentgemma-9b", "musicgen-large",
            "llama-3.2-vision-90b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _same_cache(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g, w)


def _asdicts(leaves):
    return [dataclasses.asdict(s) for s in leaves]


@pytest.mark.parametrize("name", FAMILIES)
def test_specs_and_init_cache_match_reference(name):
    """Parameter and cache spec trees (bf16, as configured), the zero cache
    with its fp32 recurrent states, and the parameter counts at full
    size."""
    jcfg, cfg = _cfgs(name, "bfloat16")
    is_spec = lambda x: hasattr(x, "axes")  # noqa: E731
    assert _asdicts(tree_leaves(M.param_specs(cfg))) == _asdicts(
        jax.tree.leaves(JM.param_specs(jcfg), is_leaf=is_spec))
    assert _asdicts(tree_leaves(M.cache_specs(cfg, 2, 16))) == _asdicts(
        jax.tree.leaves(JM.cache_specs(jcfg, 2, 16), is_leaf=is_spec))
    got, want = M.init_cache(cfg, 2, 16, "cpu"), JM.init_cache(jcfg, 2, 16)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))
    states = [x for p, x in jax.tree_util.tree_flatten_with_path(want)[0]
              if jax.tree_util.keystr(p).endswith(("['state']", "['h']"))]
    assert all(x.dtype == jnp.float32 for x in states)
    assert M.n_params(configs.get_config(name)) == JM.n_params(
        jconfigs.get_config(name))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    """Prefill 16 tokens (with the image embeddings for the VLM) into 24
    slots, then 8 decode steps fed the same tokens in both packages:
    logits and every cache leaf after each."""
    jcfg, cfg = _cfgs(name)
    _, jp, tp = _params(jcfg, condition=True)
    jb, tb = _batch_for(cfg, seed=6, b=2, s=24)
    jl, jc = JM.prefill(jcfg, jp, jb["tokens"][:, :16], capacity=24,
                        image_embeds=jb.get("image_embeds"))
    tl, tc = M.prefill(cfg, tp, tb["tokens"][:, :16], capacity=24,
                       image_embeds=tb.get("image_embeds"))
    _close(tl, jl)
    _same_cache(tc, jc)
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))  # as serve.py
    for i in range(16, 24):
        jl, jc = jdecode(jp, jc, jb["tokens"][:, i:i + 1])
        tl, tc = M.decode_step(cfg, tp, tc, tb["tokens"][:, i:i + 1])
        _close(tl, jl)
        _same_cache(tc, jc)
    assert int(tc["t"]) == 24


@pytest.mark.parametrize("name", ["mamba2-130m", "recurrentgemma-9b",
                                  "musicgen-large"])
def test_port_decode_matches_its_full_forward(name):
    """The reference's check on the port: prefill 8 tokens, decode the next
    8 one at a time, against the full forward (the VLM's, with its image
    embeddings, is in ``test_torch_xattn_audio.py``)."""
    jcfg, cfg = _cfgs(name)
    _, _, tp = _params(jcfg)
    _, tb = _batch_for(cfg, seed=9, b=2, s=16)
    toks = tb["tokens"]
    full, _, _ = M.forward(cfg, tp, toks)
    _, cache = M.prefill(cfg, tp, toks[:, :8], capacity=16)
    outs = []
    for i in range(8, 16):
        li, cache = M.decode_step(cfg, tp, cache, toks[:, i:i + 1])
        outs.append(li)
    _close(torch.cat(outs, 1), full[:, 8:], 2e-2, 2e-2)
