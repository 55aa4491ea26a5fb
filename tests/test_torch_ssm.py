"""The port's Mamba-2 (SSD) block and its depthwise causal conv against the
JAX package's, on the CPU, on numpy-seeded inputs and the reference's own
weights (carried across by ``interop``).

Tolerances, and why:
  conv      ``causal_conv1d`` and ``conv1d_step`` sum their taps in the
            reference's order, in fp32: held ``==``, in fp32 and bf16.
  modules   ``_ssd_chunked`` and ``ssm_apply`` in fp32 within rtol 1e-5 /
            atol 1e-5: the three-operand einsums are contracted in another
            order than XLA picks.
  model     mamba2-130m reduced (2 layers, d_model 64, vocab 128, fp32):
            logits, loss and gradients within rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.spec import init_params as jinit_params
from repro_torch import interop, tree_leaves
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import ssm

from _torch_families import _batch_for, _cfgs, _grads_port, _params

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _both(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of ``a`` in ``dtype``, the same values."""
    j = jnp.asarray(a).astype(dtype)
    return j, interop.to_torch(np.asarray(j), "cpu")


# --------------------------------------------------------------------------
# the depthwise causal conv
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_equals_reference(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 9, 6)), dtype)
    jw, tw = _both(rng.standard_normal((4, 6)), dtype)
    got = layers.causal_conv1d(tx, tw)
    want = jlayers.causal_conv1d(jx, jw)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_step_equals_reference(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 6)), dtype)
    jc, tc = _both(rng.standard_normal((2, 3, 6)), dtype)
    jw, tw = _both(rng.standard_normal((4, 6)), dtype)
    got, got_c = layers.conv1d_step(tx, tc, tw)
    want, want_c = jlayers.conv1d_step(jx, jc, jw)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_c), _np(want_c))


def test_conv1d_step_continues_causal_conv1d():
    """Stepping through a sequence from a zero past gives the full conv's
    outputs, bit for bit (the same taps in the same order)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    full = layers.causal_conv1d(x, w)
    past = torch.zeros(2, 3, 5)
    for t in range(7):
        out, past = layers.conv1d_step(x[:, t], past, w)
        assert torch.equal(out, full[:, t])


# --------------------------------------------------------------------------
# the chunked SSD pass
# --------------------------------------------------------------------------
def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, bm, cm, st


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (24, 24), (16, 32)])
def test_ssd_chunked_matches_reference(s, chunk, init):
    x, a, bm, cm, st = _ssd_inputs(s + chunk, 2, s, 3, 4, 8)
    st = st if init else None
    y, final = ssm._ssd_chunked(
        *(torch.from_numpy(v) for v in (x, a, bm, cm)), chunk,
        None if st is None else torch.from_numpy(st))
    jy, jfinal = jssm._ssd_chunked(
        *(jnp.asarray(v) for v in (x, a, bm, cm)), chunk,
        None if st is None else jnp.asarray(st))
    _close(y, jy)
    _close(final, jfinal)
    assert y.dtype == torch.float32 and final.dtype == torch.float32


def test_ssd_chunked_halves_with_state_equal_one_pass():
    """The reference's prefill-state handoff check on the port: two halves
    with the state passed equal one full pass."""
    x, a, bm, cm, _ = (torch.from_numpy(v)
                       for v in _ssd_inputs(3, 1, 32, 2, 4, 4))
    y_full, st_full = ssm._ssd_chunked(x, a, bm, cm, 8, None)
    y1, st1 = ssm._ssd_chunked(x[:, :16], a[:, :16], bm[:, :16], cm[:, :16],
                               8, None)
    y2, st2 = ssm._ssd_chunked(x[:, 16:], a[:, 16:], bm[:, 16:], cm[:, 16:],
                               8, st1)
    _close(torch.cat([y1, y2], 1), y_full, 1e-4, 1e-4)
    _close(st2, st_full, 1e-4, 1e-4)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x, a, bm, cm, _ = (torch.from_numpy(v)
                       for v in _ssd_inputs(4, 1, 12, 2, 4, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ssm._ssd_chunked(x, a, bm, cm, 8, None)


# --------------------------------------------------------------------------
# the block: training, prefill from a state, decode
# --------------------------------------------------------------------------
def _block_setup():
    """The block's weights (the reference's init with A_log, D and dt_bias
    redrawn at random: their zeros / ones hide a wrong decay or skip
    path), a numpy-seeded input stream and a random incoming state."""
    jcfg, cfg = _cfgs("mamba2-130m")
    rng = np.random.default_rng(11)
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jinit_params(
        jax.random.PRNGKey(3), jssm.ssm_specs(jcfg)))
    for key in ("A_log", "D", "dt_bias"):
        p_np[key] = (0.5 * rng.standard_normal(p_np[key].shape)).astype(
            np.float32)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    cache = {k: np.zeros(s.shape, np.float32)
             for k, s in jssm.ssm_cache_specs(jcfg, 2).items()}
    cache["state"] = (0.3 * rng.standard_normal(cache["state"].shape)
                      ).astype(np.float32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, p_np),
            interop.to_torch(p_np, "cpu"), x, cache)


def test_ssm_specs_match_reference():
    jcfg, cfg = _cfgs("mamba2-130m")
    for got, want in ((ssm.ssm_specs(cfg), jssm.ssm_specs(jcfg)),
                      (ssm.ssm_cache_specs(cfg, 3),
                       jssm.ssm_cache_specs(jcfg, 3))):
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()}


def test_ssm_apply_training_matches_reference():
    jcfg, cfg, jp, tp, x, _ = _block_setup()
    y, c = ssm.ssm_apply(cfg, tp, torch.from_numpy(x))
    jy, jc = jssm.ssm_apply(jcfg, jp, jnp.asarray(x))
    assert c is None and jc is None
    _close(y, jy)


def test_ssm_apply_prefill_and_decode_match_reference():
    """Prefill 16 tokens from a random incoming state (written into the
    cache in place: the final state and the raw conv tails), then 4 decode
    steps; outputs and every cache leaf after each."""
    jcfg, cfg, jp, tp, x, cache = _block_setup()
    jc = jax.tree.map(jnp.asarray, cache)
    tc = interop.to_torch(cache, "cpu")
    held = dict(tc)  # the same tensors: the port writes into them
    y, out = ssm.ssm_apply(cfg, tp, torch.from_numpy(x[:, :16]), cache=tc)
    jy, jc = jssm.ssm_apply(jcfg, jp, jnp.asarray(x[:, :16]), cache=jc)
    _close(y, jy)
    assert out is tc and all(out[k] is held[k] for k in held)
    for k in jc:
        _close(tc[k], jc[k])
    for t in range(16, 20):
        y, tc = ssm.ssm_apply(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                              cache=tc)
        jy, jc = jssm.ssm_apply(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                cache=jc)
        _close(y, jy)
        for k in jc:
            _close(tc[k], jc[k])
    assert tc["state"].dtype == torch.float32


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------
def test_mamba2_logits_loss_and_grads_match_reference():
    jcfg, cfg = _cfgs("mamba2-130m")
    _, jp, tp = _params(jcfg)
    jb, tb = _batch_for(cfg, seed=1)
    jl, _, _ = JM.forward(jcfg, jp, jb["tokens"])
    tl, _, _ = M.forward(cfg, tp, tb["tokens"])
    _close(tl, jl, 1e-4, 1e-5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)[0])(jp)
    loss, grads = _grads_port(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jgrads), strict=True):
        _close(g, w, 1e-4, 1e-5)
    assert len(tree_leaves(tp)) == len(grads)


def test_ssd_gradient_overflow_witness_copies_the_reference():
    """The reference's fault, copied: the intra-chunk decay exp(ldec) is
    taken over the whole (Q, Q) square and then masked to its lower
    triangle, so where the decay summed over a span of the chunk passes
    88.7 the masked entries are inf. The forward stays finite, but the
    gradient through the mask is 0 * inf = NaN, in both packages. At lr
    0.05 full-width mamba2-130m gets there within two FedAvg rounds."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 16, 1, 2)).astype(np.float32)
    bm = rng.standard_normal((1, 16, 2)).astype(np.float32)
    cm = rng.standard_normal((1, 16, 2)).astype(np.float32)
    a = np.full((1, 16, 1), -6.0, np.float32)  # 15 x 6 = 90 over a chunk

    def jloss(ja):
        return jssm._ssd_chunked(jnp.asarray(x), ja, jnp.asarray(bm),
                                 jnp.asarray(cm), 16, None)[0].sum()

    ta = torch.from_numpy(a).requires_grad_(True)
    y, _ = ssm._ssd_chunked(torch.from_numpy(x), ta, torch.from_numpy(bm),
                            torch.from_numpy(cm), 16, None)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(float(y.sum()), float(jloss(jnp.asarray(a))),
                               rtol=1e-5)
    (g,) = torch.autograd.grad(y.sum(), ta)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(a)))
    assert np.isnan(jg).any() and bool(torch.isnan(g).any())
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(jg))
