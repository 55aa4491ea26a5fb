"""The port's cross-attention (the VLM's ``xattn`` blocks over image
embeddings) and audio codebooks (summed per-codebook embeddings, one head
per codebook) against the JAX package's, on the CPU, on numpy-seeded
inputs and the reference's own weights (carried across by ``interop``).

Tolerances, and why:
  module    ``cross_attention`` in fp32 within rtol 1e-5 / atol 1e-5, with
            and without qk_norm (matrix products summed in another order),
            its projections rescaled to a fan-in over their input axes as
            below: seeded, without qk_norm, an output of magnitude 20 moves
            by 5.5e-5 under fp32 rounding.
  models    llama-3.2-vision-90b reduced (5 layers: attn x4, xattn; 16
            image tokens) and musicgen-large reduced (2 layers, 4
            codebooks), d_model 64, vocab 128, fp32: logits, loss and
            gradients within rtol 1e-4 / atol 1e-5, from weights whose
            attention projections are rescaled to a fan-in over their input
            axes (``_params(condition=True)``): neither config has qk_norm,
            and from the init alone fp32 rounding moves a VLM logit by 7e-4.
  decode    the port's decode against its own full forward at the
            reference's ``test_decode_matches_full_forward`` bound, rtol /
            atol 2e-2; against the reference's decode within rtol 1e-4 /
            atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.spec import init_params as jinit_params
from repro_torch import interop, tree_leaves
from repro_torch.models import attention as attn
from repro_torch.models import model as M

from _torch_families import _batch_for, _cfgs, _grads_port, _params

torch.set_num_threads(1)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """Training (no cache), prefill (K/V projected from the image
    embeddings and written into the cache in place) and two decode steps
    (K/V read from the cache)."""
    jcfg, cfg = _cfgs("llama-3.2-vision-90b")
    jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
    cfg = dataclasses.replace(cfg, qk_norm=qk_norm)
    rng = np.random.default_rng(13)
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jinit_params(
        jax.random.PRNGKey(5), jattn.attn_specs(jcfg, cross=True)))
    for k in ("wq", "wk", "wv"):  # (d, heads, head_dim)
        p_np[k] = p_np[k] * np.float32(np.sqrt(p_np[k].shape[1] /
                                               p_np[k].shape[0]))
    p_np["wo"] = p_np["wo"] / np.float32(np.sqrt(p_np["wo"].shape[0]))
    if qk_norm:  # away from the ones of the init
        for k in ("q_norm", "k_norm"):
            p_np[k] = (1 + 0.3 * rng.standard_normal(p_np[k].shape)).astype(
                np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p_np), interop.to_torch(p_np, "cpu")
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, cfg.num_image_tokens, cfg.d_model)).astype(
        np.float32)

    y, c = attn.cross_attention(cfg, tp, torch.from_numpy(x),
                                torch.from_numpy(img))
    jy, jc = jattn.cross_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(img))
    assert c is None and jc is None
    _close(y, jy, 1e-5, 1e-5)

    specs = attn.xattn_cache_specs(cfg, 2)
    assert {k: dataclasses.asdict(v) for k, v in specs.items()} == {
        k: dataclasses.asdict(v)
        for k, v in jattn.xattn_cache_specs(jcfg, 2).items()}
    tc = {k: torch.full(s.shape, 7.0) for k, s in specs.items()}  # garbage
    held = dict(tc)
    jc = {k: jnp.zeros(s.shape, jnp.float32) for k, s in specs.items()}
    y, tc = attn.cross_attention(cfg, tp, torch.from_numpy(x[:, :8]),
                                 torch.from_numpy(img), tc)
    jy, jc = jattn.cross_attention(jcfg, jp, jnp.asarray(x[:, :8]),
                                   jnp.asarray(img), jc)
    _close(y, jy, 1e-5, 1e-5)
    assert all(tc[k] is held[k] for k in held)
    for k in ("k", "v"):
        _close(tc[k], jc[k], 1e-5, 1e-5)
    for t in (8, 9):
        y, tc = attn.cross_attention(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                     None, tc)
        jy, jc = jattn.cross_attention(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                       None, jc)
        _close(y, jy, 1e-5, 1e-5)


# --------------------------------------------------------------------------
# the whole models: forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "musicgen-large"])
def test_logits_loss_and_grads_match_reference(name):
    jcfg, cfg = _cfgs(name)
    _, jp, tp = _params(jcfg, condition=True)
    jb, tb = _batch_for(cfg, seed=3)
    jl, _, _ = JM.forward(jcfg, jp, jb["tokens"],
                          image_embeds=jb.get("image_embeds"))
    tl, _, _ = M.forward(cfg, tp, tb["tokens"],
                         image_embeds=tb.get("image_embeds"))
    if cfg.num_codebooks:
        assert tl.shape == (4, 32, cfg.num_codebooks, cfg.vocab_size)
    _close(tl, jl)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)[0])(jp)
    loss, grads = _grads_port(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jgrads), strict=True):
        _close(g, w)


def test_codebook_embedding_sums_each_codebook():
    """The audio embedding is the sum of one lookup per codebook, and the
    head gives one set of logits per codebook."""
    _, cfg = _cfgs("musicgen-large")
    tp = M.init(cfg, torch.Generator().manual_seed(0))
    assert tp["embed"].shape == (4, 128, 64)
    assert tp["lm_head"].shape == (4, 64, 128)
    tok = torch.randint(0, 128, (2, 5, 4), generator=torch.Generator()
                        .manual_seed(1))
    want = sum(tp["embed"][k][tok[..., k]] for k in range(4))
    torch.testing.assert_close(M._embed(cfg, tp, tok), want, rtol=0, atol=0)
    h = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(
        M._head(cfg, tp, h)[:, :, 2], h @ tp["lm_head"][2])


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def test_vlm_decode_matches_full_forward():
    """The reference's VLM check on the port: prefill 5 tokens with the
    image embeddings, decode 5 more from the cached image K/V, against the
    full forward."""
    jcfg, cfg = _cfgs("llama-3.2-vision-90b")
    _, _, tp = _params(jcfg)
    _, tb = _batch_for(cfg, seed=4, b=2, s=10)
    tok, img = tb["tokens"], tb["image_embeds"]
    full, _, _ = M.forward(cfg, tp, tok, image_embeds=img)
    _, cache = M.prefill(cfg, tp, tok[:, :5], image_embeds=img, capacity=10)
    outs = []
    for i in range(5, 10):
        li, cache = M.decode_step(cfg, tp, cache, tok[:, i:i + 1])
        outs.append(li)
    _close(torch.cat(outs, 1), full[:, 5:], 2e-2, 2e-2)


def test_codebook_decode_matches_reference():
    """musicgen-large: prefill 8 codebook frames (B, 8, 4), then 4 decode
    steps of one frame each, logits (B, 1, 4, V) and the KV cache against
    the reference's; greedy tokens per codebook agree."""
    jcfg, cfg = _cfgs("musicgen-large")
    _, jp, tp = _params(jcfg, condition=True)
    jb, tb = _batch_for(cfg, seed=5, b=2, s=12)
    jl, jc = JM.prefill(jcfg, jp, jb["tokens"][:, :8], capacity=12)
    tl, tc = M.prefill(cfg, tp, tb["tokens"][:, :8], capacity=12)
    _close(tl, jl)
    for i in range(8, 12):
        jl, jc = JM.decode_step(jcfg, jp, jc, jb["tokens"][:, i:i + 1])
        tl, tc = M.decode_step(cfg, tp, tc, tb["tokens"][:, i:i + 1])
        assert tl.shape == (2, 1, 4, cfg.vocab_size)
        _close(tl, jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc), strict=True):
        if np.asarray(a).dtype == np.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)
