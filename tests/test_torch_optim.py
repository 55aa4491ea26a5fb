"""The port's optimizers and schedules against the JAX package's, on the CPU,
step for step from the same numpy-seeded parameters and gradients, with fp32
and bf16 parameters.

Tolerance: rtol 1e-6 / atol 1e-7 on every parameter, moment and lr. Both
packages do the same fp32 operations in the same order on the same inputs;
what may differ is the last bit of a transcendental (``cos``, ``pow``,
``sqrt``) or of a fused multiply-add, about 1e-7 of the value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import interop, optim, tree_leaves, tree_map

torch.set_num_threads(1)

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": (7, 6)}
RTOL, ATOL = 1e-6, 1e-7
N_STEPS = 5


def _tree(rng, dtype, scale=1.0):
    def draw(shape):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(dtype))

    return jax.tree.map(draw, SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _close(got, want, rtol=RTOL, atol=ATOL):
    gl, wl = tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            g = interop.bf16_from_bits(g).float().numpy()
            w = w.astype(np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _run_both(jopt, topt, dtype, n_steps=N_STEPS, grad_scale=1.0):
    """Run both optimizers ``n_steps`` from the same params and the same
    gradients each step; compare params and state after every step."""
    rng = np.random.default_rng(0)
    params_np = _tree(rng, dtype)
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = interop.to_torch(params_np, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(n_steps):
        g_np = _tree(rng, dtype, grad_scale)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        tp, ts = topt.update(interop.to_torch(g_np, "cpu"), ts, tp)
        _close(tp, jp)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
        for k in ("mom", "m", "v"):
            if k in js:
                if js[k] is None:
                    assert ts[k] is None
                else:
                    _close(ts[k], js[k])
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    return tp, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    rng = np.random.default_rng(1)
    tree_np = _tree(rng, dtype, scale=3.0)
    jt = jax.tree.map(jnp.asarray, tree_np)
    tt = interop.to_torch(tree_np, "cpu")
    got, want = optim.global_norm(tt), joptim.global_norm(jt)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    for max_norm in (0.5, 1.0, 1e6):  # clipped, clipped, left alone
        _close(optim.clip_by_global_norm(tt, max_norm),
               joptim.clip_by_global_norm(jt, max_norm))


def _schedules(lib):
    return {
        "constant": lib.constant(0.3),
        "cosine": lib.cosine_decay(0.3, 7, alpha=0.1),
        "warmup_cosine": lib.linear_warmup_cosine(0.3, 3, 9, alpha=0.05),
    }


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    fn, jfn = _schedules(optim)[name], _schedules(joptim)[name]
    for step in range(0, 12):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = fn(arg)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), want, rtol=RTOL,
                                       atol=ATOL)


def _optimizers(lib, sched):
    return {
        "sgd": lib.sgd(0.05),
        "sgd_momentum": lib.sgd(0.05, momentum=0.9),
        "sgd_momentum_cosine": lib.sgd(sched, momentum=0.9),
        "adam": lib.adam(1e-2),
        "adamw": lib.adamw(3e-4),
        "adamw_warmup_cosine": lib.adamw(sched),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "sgd_momentum",
                                  "sgd_momentum_cosine", "adam", "adamw",
                                  "adamw_warmup_cosine"])
def test_optimizer_matches_reference_step_for_step(name, dtype):
    topt = _optimizers(optim, optim.linear_warmup_cosine(0.1, 2, 6))[name]
    jopt = _optimizers(joptim, joptim.linear_warmup_cosine(0.1, 2, 6))[name]
    assert topt.name == jopt.name
    _run_both(jopt, topt, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgd_momentum0_is_plain_sgd_bit_for_bit(dtype):
    """``sgd(lr)`` at momentum 0 computes what the port's plain SGD always
    has (``fl/party.py`` trains with it): p32 - lr * g32, cast back."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 33, generator=gen).to(dtype),
              "b": torch.randn(17, generator=gen).to(dtype)}
    opt = optim.sgd(0.05)
    state = opt.init(params)
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(dtype), params)
        want = tree_map(lambda p, g: (p.to(torch.float32) - 0.05 *
                                      g.to(torch.float32)).to(p.dtype),
                        params, grads)
        params, state = opt.update(grads, state, params)
        for a, b in zip(tree_leaves(params), tree_leaves(want)):
            assert torch.equal(a, b)
    assert int(state["step"]) == 3 and state["mom"] is None


def test_adamw_state_crosses_the_boundary_both_ways():
    """AdamW's state (0-d int32 step, fp32 moments) from the reference
    carried into the port by ``interop`` and back, bit for bit; and the
    port continues from it as the reference does."""
    rng = np.random.default_rng(3)
    params_np = _tree(rng, "bfloat16")
    jopt, topt = joptim.adamw(1e-2), optim.adamw(1e-2)
    jp = jax.tree.map(jnp.asarray, params_np)
    js = jopt.init(jp)
    for _ in range(2):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, _tree(rng, "bfloat16")),
                             js, jp)
    ts = interop.to_torch(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    back = interop.to_numpy(ts)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    g_np = _tree(rng, "bfloat16")
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tp, ts = topt.update(interop.to_torch(g_np, "cpu"), ts, tp)
    jp, js = jopt.update(jax.tree.map(jnp.asarray, g_np), js, jp)
    _close(tp, jp)
    _close(ts["m"], js["m"])
