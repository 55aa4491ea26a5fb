"""The port's launchers against the JAX package's, on the CPU.

The train step is held against ``repro.launch.steps.make_train_step``
called outside ``activation_sharding`` (where ``constrain`` does nothing);
``repro.launch.train.main`` itself fails on this JAX (ROADMAP Queue 3).
Config: qwen3-0.6b reduced (2 layers, d_model 64, vocab 128) in fp32, from
the reference's own weights, on numpy-seeded tokens.

AdamW's first step moves each element by about lr x g / |g|, so an element
whose gradient is near 0 and differs in sign between the packages moves by
2 x lr. So the pieces are held one by one:
  gradients   against ``jax.grad``: rtol 1e-4 / atol 1e-6 (fp32 sums in
              another order);
  clipping    of the reference's gradients: rtol 1e-6 / atol 1e-7;
  the update  from the reference's gradients: rtol 1e-6 / atol 1e-7;
  3 steps     losses within rtol 1e-5. The parameters after 3 whole steps
              may part by rounding carried through three steps: at most 1
              in 10,000 elements lies outside rtol 1e-5 / atol 1e-5 (1 of
              311,872 here, 1.04e-5 off), and none is lr / 2 or further
              from the reference's, so no element's step changed sign.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro_torch import configs, interop, tree_leaves, tree_unflatten
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import serve, steps, train
from repro_torch.models import model as M
from repro_torch.optim import adamw, clip_by_global_norm

torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()
LR = 3e-4


def _setup(seed=0):
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(**kw)
    cfg = configs.get_config("qwen3-0.6b").reduced(**kw)
    p_np = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, cfg, p_np


def _batch(step, vocab=128):
    rng = np.random.default_rng(100 + step)
    tok = rng.integers(0, vocab, (4, 32)).astype(np.int32)
    data = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def _allclose(got, want, rtol, atol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def test_train_step_pieces_match_reference():
    jcfg, cfg, p_np = _setup()
    jb, tb = _batch(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = interop.to_torch(p_np, "cpu")
    # gradients
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(jcfg, p, jb)[0]))(jp)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = M.loss_fn(cfg, tree_unflatten(tp, leaves), tb)
    tgrads = tree_unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    _allclose(tgrads, jgrads, 1e-4, 1e-6)
    # clipping, from the reference's gradients
    g_np = jax.tree.map(np.asarray, jgrads)
    jclipped = jclip(jgrads, 1.0)
    tclipped = clip_by_global_norm(interop.to_torch(g_np, "cpu"), 1.0)
    _allclose(tclipped, jclipped, 1e-6, 1e-7)
    # the update, from the reference's clipped gradients
    jopt, topt = jadamw(LR), adamw(LR)
    c_np = jax.tree.map(np.asarray, jclipped)
    jnew, jstate = jopt.update(jclipped, jopt.init(jp), jp)
    tnew, tstate = topt.update(interop.to_torch(c_np, "cpu"), topt.init(tp),
                               tp)
    _allclose(tnew, jnew, 1e-6, 1e-7)
    _allclose(tstate["m"], jstate["m"], 1e-6, 1e-7)
    _allclose(tstate["v"], jstate["v"], 1e-6, 1e-7)


def test_train_step_matches_reference_over_three_steps():
    jcfg, cfg, p_np = _setup()
    jstep = jax.jit(jsteps.make_train_step(jcfg))  # as train.py
    tstep = steps.make_train_step(cfg)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = interop.to_torch(p_np, "cpu")
    js, ts = jadamw(LR).init(jp), adamw(LR).init(tp)
    for i in range(3):
        jb, tb = _batch(i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    n = bad = 0
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        g, w = g.numpy(), np.asarray(w)
        err = np.abs(g - w)
        bad += int((err > 1e-5 + 1e-5 * np.abs(w)).sum())
        n += w.size
        assert err.max() < 0.5 * LR, err.max()
    assert bad <= 1e-4 * n, (bad, n)


def _asdicts(tree):
    return [dataclasses.asdict(s) for s in tree_leaves(tree)]


def _jasdicts(tree):
    return [dataclasses.asdict(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "axes"))]


@pytest.mark.parametrize("name", configs.ARCH_IDS + ["example-100m"])
def test_specs_and_capacity_match_reference(name):
    """opt_state_specs, batch_specs, decode_capacity and build's abstract
    arguments and donations, for every config the port carries and every
    input shape."""
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert _asdicts(steps.opt_state_specs(M.param_specs(cfg))) == _jasdicts(
        jsteps.opt_state_specs(JM.param_specs(jcfg)))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    assert set(INPUT_SHAPES) == set(JINPUT_SHAPES)
    for sname, shape in INPUT_SHAPES.items():
        jshape = JINPUT_SHAPES[sname]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert _asdicts(steps.batch_specs(cfg, shape)) == _jasdicts(
            jsteps.batch_specs(jcfg, jshape))
        assert steps.decode_capacity(cfg, shape) == jsteps.decode_capacity(
            jcfg, jshape)
        _, args, donate = steps.build(cfg, shape)
        _, jargs, _, jdonate = jsteps.build(jcfg, jshape, mesh)
        assert donate == jdonate
        got, want = tree_leaves(args), jax.tree.leaves(jargs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "meta"
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_launchers_run_reduced_on_the_cpu(capsys):
    assert train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "2",
                       "--seq-len", "64", "--batch", "4",
                       "--device", "cpu"]) == 0
    assert serve.main(["--arch", "qwen3-0.6b", "--reduced", "--prompt-len",
                       "8", "--tokens", "3", "--batch", "2",
                       "--device", "cpu"]) == 0
    assert serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok\n") == 3 and "step 1: loss=" in out
    assert "generated (2, 3) tokens" in out


def test_launchers_raise_without_a_card_or_the_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    # the production mesh needs its 256 ranks (the reference's needs its
    # 256 devices); --reduced overrides the shape and the mesh, as in the
    # reference, and --force-host steps dry with no card
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.main(["--shape", "train_4k", "--device", "cpu"])
    assert train.main(["--reduced", "--device", "cpu", "--steps", "1",
                       "--shape", "train_4k", "--batch", "2",
                       "--seq-len", "8"]) == 0
    assert train.main(["--reduced", "--force-host", "--steps", "1",
                       "--batch", "16", "--seq-len", "8"]) == 0
    # the optimized profile and the server's flags run, on the card unless
    # told otherwise (test_torch_launch_profiles.py)
    for main, argv in ((train.main, ["--profile", "optimized"]),
                       (serve.main, ["--profile", "optimized"]),
                       (serve.main, ["--force-host"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--reduced", *argv])


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_greedy_decode_yields_the_reference_tokens(name):
    """The reference's serve loop (prefill with capacity prompt + tokens,
    then greedy decode steps) and ``serve.generate`` from the same weights
    and prompt pick the same tokens."""
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    jcfg = jconfigs.get_config(name).reduced(**kw)
    cfg = configs.get_config(name).reduced(**kw)
    p_np = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    prompt = np.random.default_rng(5).integers(0, 128, (3, 12)).astype(
        np.int32)
    n_tokens = 10
    logits, cache = JM.prefill(jcfg, jax.tree.map(jnp.asarray, p_np),
                               jnp.asarray(prompt), capacity=12 + n_tokens)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [nxt]
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))  # as serve.py
    for _ in range(n_tokens - 1):
        logits, cache = jdecode(jax.tree.map(jnp.asarray, p_np), cache, nxt)
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(nxt)
    out = serve.generate(cfg, interop.to_torch(p_np, "cpu"),
                         torch.from_numpy(prompt), n_tokens - 1,
                         12 + n_tokens)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    assert out.finite and int(out.cache["t"]) == 12 + n_tokens - 1
