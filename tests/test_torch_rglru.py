"""The port's RG-LRU block, its parallel scan, the ``rglru_lambda``
initialiser and the hybrid embedding scale against the JAX package's, on
the CPU, on numpy-seeded inputs and the reference's own weights (carried
across by ``interop``).

Tolerances, and why:
  scan      ``_linear_scan`` is the odd-even recursion of
            ``jax.lax.associative_scan``, the same products and sums in the
            same association order: within rtol 1e-6 / atol 1e-7 of the
            reference's scan in fp32 (a sum may still round once more or
            less where one side fuses a multiply-add), and within 1e-5 of a
            plain sequential loop.
  modules   ``_gates`` and ``rglru_apply`` in fp32 within rtol 1e-5 / atol
            1e-5 (matrix products summed in another order).
  model     recurrentgemma-9b reduced (5 layers: the (rglru, rglru, lattn)
            stage and the (rglru, rglru) remainder; d_model 64, vocab 128,
            fp32): logits, loss and gradients within rtol 1e-4 / atol 1e-5,
            from weights whose attention projections are rescaled to a
            fan-in over their input axes (``_params(condition=True)``): the
            MQA ``wk`` draws with fan-in 1 and, seeded, sharpens the
            attention until fp32 rounding moves a logit by 1e-4.
  embedding the hybrid scale is sqrt(d_model) rounded to the embedding's
            dtype, then one product: ``==`` in bf16 and fp32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import rglru as jrglru
from repro.models.spec import init_params as jinit_params
from repro_torch import interop
from repro_torch.models import model as M
from repro_torch.models import rglru
from repro_torch.models.spec import TensorSpec, init_params

from _torch_families import _batch_for, _cfgs, _grads_port, _params

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------
def _jax_scan(a, b):
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    return jax.lax.associative_scan(combine, (a, b), axis=1)


@pytest.mark.parametrize("s", [1, 2, 3, 8, 13, 64])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.05, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    got_a, got_b = rglru._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want_a, want_b = _jax_scan(jnp.asarray(a), jnp.asarray(b))
    _close(got_a, want_a, 1e-6, 1e-7)
    _close(got_b, want_b, 1e-6, 1e-7)
    h, loop = np.zeros((2, 5), np.float32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    _close(got_b, np.stack(loop, 1))


# --------------------------------------------------------------------------
# the initialiser
# --------------------------------------------------------------------------
def test_rglru_lambda_init_gives_griffin_decays():
    """Lambda = softplus^{-1}(-log(a) / 8) for a uniform in [0.9, 0.999),
    drawn from the caller's generator: the decay at r = 1 lies there, the
    draw repeats from the same seed, and the reference's lies there too."""
    spec = TensorSpec((4096,), (None,), init="rglru_lambda", dtype="float32")
    lam = init_params(torch.Generator().manual_seed(0), {"L": spec})["L"]
    again = init_params(torch.Generator().manual_seed(0), {"L": spec})["L"]
    assert torch.equal(lam, again) and lam.dtype == torch.float32
    jspec = dataclasses.replace(jrglru.rglru_specs(
        _cfgs("recurrentgemma-9b")[0])["Lambda"], dtype="float32")
    for x in (lam.numpy(), np.asarray(jinit_params(
            jax.random.PRNGKey(0), {"L": jspec})["L"])):
        a = np.exp(-8.0 * np.logaddexp(x.astype(np.float64), 0.0))
        assert a.min() >= 0.9 - 1e-6 and a.max() < 0.999 + 1e-6
        assert a.max() - a.min() > 0.09  # spread over the range


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------
def _block_setup():
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    rng = np.random.default_rng(12)
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jinit_params(
        jax.random.PRNGKey(4), jrglru.rglru_specs(jcfg)))
    x = (0.5 * rng.standard_normal((2, 24, jcfg.d_model))).astype(np.float32)
    cache = {"h": (0.3 * rng.standard_normal((2, jcfg.rnn_width))).astype(
                 np.float32),
             "conv": np.zeros((2, jcfg.conv_kernel - 1, jcfg.rnn_width),
                              np.float32)}
    return (jcfg, cfg, jax.tree.map(jnp.asarray, p_np),
            interop.to_torch(p_np, "cpu"), x, cache)


def test_rglru_specs_match_reference():
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    for got, want in ((rglru.rglru_specs(cfg), jrglru.rglru_specs(jcfg)),
                      (rglru.rglru_cache_specs(cfg, 3),
                       jrglru.rglru_cache_specs(jcfg, 3))):
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()}


def test_gates_match_reference_and_decay_in_unit_interval():
    jcfg, cfg, jp, tp, _, _ = _block_setup()
    u = np.random.default_rng(5).standard_normal(
        (4, 8, cfg.rnn_width)).astype(np.float32)
    a, bi = rglru._gates(cfg, tp, torch.from_numpy(u))
    ja, jbi = jrglru._gates(jcfg, jp, jnp.asarray(u))
    _close(a, ja)
    _close(bi, jbi)
    assert bool((a > 0).all()) and bool((a < 1).all())
    assert bool(torch.isfinite(bi).all())


def test_rglru_apply_training_matches_reference():
    jcfg, cfg, jp, tp, x, _ = _block_setup()
    y, c = rglru.rglru_apply(cfg, tp, torch.from_numpy(x))
    jy, jc = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x))
    assert c is None and jc is None
    _close(y, jy)


def test_rglru_apply_prefill_and_decode_match_reference():
    """Prefill 16 steps from a nonzero incoming state (folded into the
    first element), written into the cache in place, then 4 decode
    steps."""
    jcfg, cfg, jp, tp, x, cache = _block_setup()
    jc = jax.tree.map(jnp.asarray, cache)
    tc = interop.to_torch(cache, "cpu")
    h_t, conv_t = tc["h"], tc["conv"]
    y, out = rglru.rglru_apply(cfg, tp, torch.from_numpy(x[:, :16]),
                               cache=tc)
    jy, jc = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x[:, :16]), cache=jc)
    _close(y, jy)
    assert out["h"] is h_t and out["conv"] is conv_t
    for k in jc:
        _close(tc[k], jc[k])
    for t in range(16, 20):
        y, tc = rglru.rglru_apply(cfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                  cache=tc)
        jy, jc = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                    cache=jc)
        _close(y, jy)
        for k in jc:
            _close(tc[k], jc[k])
    assert tc["h"].dtype == torch.float32


def test_rglru_scan_equals_steps():
    """The reference's scan-against-steps check on the port, at its
    bound (rtol / atol 2e-3): the scan over 12 steps against 12 decode
    steps from a zero cache."""
    _, cfg, _, tp, x, _ = _block_setup()
    x = torch.from_numpy(x[:, :12])
    y_scan, _ = rglru.rglru_apply(cfg, tp, x)
    cache = {"h": torch.zeros(2, cfg.rnn_width),
             "conv": torch.zeros(2, cfg.conv_kernel - 1, cfg.rnn_width)}
    steps = [rglru.rglru_apply(cfg, tp, x[:, t:t + 1], cache=cache)[0]
             for t in range(12)]
    _close(torch.cat(steps, 1), y_scan, 2e-3, 2e-3)


# --------------------------------------------------------------------------
# the whole model and the hybrid embedding scale
# --------------------------------------------------------------------------
def test_recurrentgemma_logits_loss_and_grads_match_reference():
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    assert cfg.stages() == ((("rglru", "rglru", "lattn"), 1),
                            (("rglru", "rglru"), 1))
    _, jp, tp = _params(jcfg, condition=True)
    jb, tb = _batch_for(cfg, seed=2)
    jl, _, _ = JM.forward(jcfg, jp, jb["tokens"])
    tl, _, _ = M.forward(cfg, tp, tb["tokens"])
    _close(tl, jl, 1e-4, 1e-5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)[0])(jp)
    loss, grads = _grads_port(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jgrads), strict=True):
        _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_embedding_scale_equals_reference(dtype):
    jcfg, cfg = _cfgs("recurrentgemma-9b", dtype)
    assert cfg.family == "hybrid"
    p_np = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(6)))
    tp = interop.to_torch(p_np, "cpu")
    tok = np.random.default_rng(6).integers(0, 128, (2, 9)).astype(np.int32)
    got = M._embed(cfg, tp, torch.from_numpy(tok))
    want = JM._embed(jcfg, jax.tree.map(jnp.asarray, p_np), jnp.asarray(tok))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the scale rounds to the dtype first: 8.0 exactly for d_model 64
    assert math.sqrt(cfg.d_model) == 8.0
    raw = torch.nn.functional.embedding(torch.from_numpy(tok).long(),
                                        tp["embed"])
    assert torch.equal(got, raw * 8.0)
