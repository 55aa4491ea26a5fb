"""The port's KV cache, prefill and ring-buffer decode against the JAX
package's, on the CPU, from the reference's own weights (carried across by
``interop``) and numpy-seeded tokens, in fp32.

Tolerance: rtol 1e-4 / atol 1e-5 on outputs, logits and cache contents
(matrix products summed in another order); cache positions and ``t`` are
held ``==``. The port's own decode against its full forward is held to the
reference's ``test_decode_matches_full_forward`` bound, rtol / atol 2e-2.

The port writes a cache in place (``decode_step`` consumes it), so a test
that keeps an old cache passes a copy.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.spec import init_params as jinit_params
from repro_torch import configs, interop, tree_leaves, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import model as M

from _torch_families import _cfgs, _params

torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()
RTOL, ATOL = 1e-4, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _same_cache(got, want):
    """Every leaf of the port's cache against the reference's: positions
    and ``t`` exactly, K/V within the file's tolerance."""
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


def _copy(cache):
    return tree_map(torch.clone, cache)


# --------------------------------------------------------------------------
# attention: the window, prefill into a cache, the ring buffer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("q_chunk", [8, 256])
@pytest.mark.parametrize("window", [1, 5, 16])
def test_windowed_attention_matches_reference(q_chunk, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)
    got = attn.chunked_causal_attn(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(pos), window=window,
                                   q_chunk=q_chunk)
    want = jattn.chunked_causal_attn(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(pos), jnp.asarray(pos),
                                     window=window, q_chunk=q_chunk)
    _close(got, want)


def _attn_setup(name="qwen3-0.6b", seed=0):
    """One attention layer's weights (the reference's init, q/k/v biases
    redrawn for a bias config) in both packages, and an input stream."""
    jcfg, cfg = _cfgs(name) if name != "qwen3-0.6b" else (
        jconfigs.get_config(name).reduced(dtype="float32"),
        configs.get_config(name).reduced(dtype="float32"))
    rng = np.random.default_rng(10 + seed)
    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jinit_params(
        jax.random.PRNGKey(seed), jattn.attn_specs(jcfg)))
    for key in ("bq", "bk", "bv"):
        if key in p_np:
            p_np[key] = (0.1 * rng.standard_normal(p_np[key].shape)
                         ).astype(np.float32)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, p_np),
            interop.to_torch(p_np, "cpu"), x)


def _empty(cfg, b, cap):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": np.zeros((b, cap, kv, hd), np.float32),
            "v": np.zeros((b, cap, kv, hd), np.float32),
            "pos": np.full((cap,), -1, np.int32)}


def _both_attention(jcfg, cfg, jp, tp, x, positions, jcache, tcache, t,
                    window):
    yj, cj = jattn.self_attention(
        jcfg, jp, jnp.asarray(x), jnp.asarray(positions), window=window,
        cache=jcache, t=None if t is None else jnp.asarray(t, jnp.int32))
    yt, ct = attn.self_attention(
        cfg, tp, torch.from_numpy(x), torch.from_numpy(positions),
        window=window, cache=tcache,
        t=None if t is None else torch.tensor(t, dtype=torch.int32))
    _close(yt, yj)
    if cj is not None:
        for key in ("k", "v", "pos"):
            if key == "pos":
                np.testing.assert_array_equal(ct[key].numpy(), cj[key])
            else:
                _close(ct[key], cj[key])
    return yt, cj, ct


@pytest.mark.parametrize("name, s, cap, window", [
    ("qwen3-0.6b", 10, 24, None),   # padded: slots 10.. zero, marked -1
    ("qwen3-0.6b", 16, 16, None),   # exactly full
    ("qwen3-0.6b", 20, 8, 8),       # trimmed: a windowed cache keeps the last 8
    ("qwen2.5-14b", 10, 24, None),  # q/k/v biases, GQA 4 / 2 heads
])
def test_prefill_fills_cache_as_reference(name, s, cap, window):
    jcfg, cfg, jp, tp, x = _attn_setup(name)
    pos = np.arange(s, dtype=np.int32)
    empty = _empty(cfg, 2, cap)
    # the port's cache starts from garbage: prefill must overwrite every slot
    garbage = {k: torch.from_numpy(v + 7) for k, v in empty.items()}
    _both_attention(jcfg, cfg, jp, tp, x[:, :s], pos,
                    jax.tree.map(jnp.asarray, empty), garbage, None, window)


@pytest.mark.parametrize("prefill, window", [(0, None), (6, 8), (8, 8),
                                             (5, None)])
def test_ring_buffer_decode_matches_reference(prefill, window):
    """Decode 10 steps into a cache of 8 slots (the ring wraps), from an
    empty cache or after a prefill no longer than the cache."""
    jcfg, cfg, jp, tp, x = _attn_setup()
    cap = 8
    jc = jax.tree.map(jnp.asarray, _empty(cfg, 2, cap))
    tc = interop.to_torch(_empty(cfg, 2, cap), "cpu")
    if prefill:
        _, jc, tc = _both_attention(jcfg, cfg, jp, tp, x[:, :prefill],
                                    np.arange(prefill, dtype=np.int32), jc,
                                    tc, None, window)
    for t in range(prefill, prefill + 10):
        _, jc, tc = _both_attention(jcfg, cfg, jp, tp,
                                    x[:, t % 24:t % 24 + 1],
                                    np.asarray([t], np.int32), jc, tc, t,
                                    window)
    # the ring holds the last 8 positions
    np.testing.assert_array_equal(np.sort(tc["pos"].numpy()),
                                  np.arange(prefill + 2, prefill + 10))


def test_long_prefill_witness_copies_the_reference():
    """A fault of the reference, copied (ROADMAP Queue 3): prefilling 10
    tokens into a windowed cache of 8 keeps positions 2..9 in slots 0..7,
    and the first decode step, at t = 10, writes slot 10 % 8 = 2, which
    holds position 4, not the oldest, 2. Position 4 lies inside the window
    and is lost, so the decode output parts from the windowed full
    forward (by 8.16 here, on outputs of up to 40.4). The port equals the
    reference here."""
    jcfg, cfg, jp, tp, x = _attn_setup()
    cap = window = 8
    jc = jax.tree.map(jnp.asarray, _empty(cfg, 2, cap))
    tc = interop.to_torch(_empty(cfg, 2, cap), "cpu")
    _, jc, tc = _both_attention(jcfg, cfg, jp, tp, x[:, :10],
                                np.arange(10, dtype=np.int32), jc, tc, None,
                                window)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.arange(2, 10))
    y_dec, jc, tc = _both_attention(jcfg, cfg, jp, tp, x[:, 10:11],
                                    np.asarray([10], np.int32), jc, tc, 10,
                                    window)
    np.testing.assert_array_equal(tc["pos"].numpy(),
                                  [2, 3, 10, 5, 6, 7, 8, 9])
    # the windowed full forward at position 10 still sees position 4
    y_full, _ = attn.self_attention(cfg, tp, torch.from_numpy(x[:, :11]),
                                    torch.arange(11, dtype=torch.int32),
                                    window=window)
    gap = float((y_dec[:, 0] - y_full[:, 10]).abs().max())
    assert gap > 1.0, gap


def test_attn_cache_specs_match_reference():
    jcfg, cfg = (jconfigs.get_config("qwen3-0.6b").reduced(),
                 configs.get_config("qwen3-0.6b").reduced())
    got, want = attn.attn_cache_specs(cfg, 3, 17), jattn.attn_cache_specs(
        jcfg, 3, 17)
    assert set(got) == set(want)
    for k in got:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])


# --------------------------------------------------------------------------
# the model: init_cache, prefill, decode_step
# --------------------------------------------------------------------------
def _model_cfgs(name):
    """(jcfg, cfg) for a reduced config; the ``lattn`` case is qwen3-0.6b
    with an ("attn", "lattn") pattern and a window of 8, built by
    ``dataclasses.replace`` on both sides."""
    if name in ("qwen2.5-14b", "qwen2-moe-a2.7b"):
        return _cfgs(name)
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(**kw)
    cfg = configs.get_config("qwen3-0.6b").reduced(**kw)
    if name == "lattn":
        over = dict(block_pattern=("attn", "lattn"), sliding_window=8,
                    num_layers=4)
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    return jcfg, cfg


def _model_setup(name):
    """(jcfg, cfg, jax params, torch params). The weights are
    ``_params(condition=True)``'s: from the init alone, the q/k/v-bias
    configs' keys reach |k| ~ 10, and fp32 rounding of their sums moves a
    small element of the cache by 1.8e-5, over the atol."""
    jcfg, cfg = _model_cfgs(name)
    _, jp, tp = _params(jcfg, condition=True)
    return jcfg, cfg, jp, tp


MODELS = ["qwen3-0.6b", "qwen2.5-14b", "qwen2-moe-a2.7b", "lattn"]


@pytest.mark.parametrize("name", MODELS)
def test_init_cache_matches_reference(name):
    jcfg, cfg = _model_cfgs(name)
    want = JM.init_cache(jcfg, 2, 16)
    got = M.init_cache(cfg, 2, 16, "cpu")
    _same_cache(got, want)
    assert got["t"].shape == () and got["t"].dtype == torch.int32
    specs, jspecs = M.cache_specs(cfg, 2, 16), JM.cache_specs(jcfg, 2, 16)
    for a, b in zip(tree_leaves(specs), jax.tree.leaves(
            jspecs, is_leaf=lambda x: hasattr(x, "axes"))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert M.n_active_params(cfg) == JM.n_active_params(jcfg)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    """Prefill 10 tokens into 16 slots, then 6 decode steps fed the same
    tokens in both packages; logits and the whole cache after each. For
    the lattn pattern the window (8) is shorter than the prompt."""
    jcfg, cfg, jp, tp = _model_setup(name)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(toks[:, :10]), capacity=16)
    tl, tc = M.prefill(cfg, tp, torch.from_numpy(toks[:, :10]), capacity=16)
    _close(tl, jl)
    _same_cache(tc, jc)
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))  # as serve.py
    for i in range(10, 16):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = M.decode_step(cfg, tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        _close(tl, jl)
        _same_cache(tc, jc)
    assert int(tc["t"]) == 16


@pytest.mark.parametrize("name", ["qwen2.5-14b", "lattn"])
def test_cache_crosses_the_boundary(name):
    """A reference cache carried into the port by ``interop`` decodes as
    the reference does; the port's cache carried back is the reference's,
    bit for bit."""
    jcfg, cfg, jp, tp = _model_setup(name)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, jnp.asarray(toks[:, :11]), capacity=12)
    tc = interop.to_torch(jax.tree.map(np.asarray, jc), "cpu")
    back = interop.to_numpy(_copy(tc))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype
    jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 11:]))
    tl, tc = M.decode_step(cfg, tp, tc, torch.from_numpy(toks[:, 11:]))
    _close(tl, jl)
    _same_cache(tc, jc)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2.5-14b", "lattn"])
def test_port_decode_matches_its_full_forward(name):
    """The reference's own check on the port: prefill 8 tokens, decode the
    next 8 one at a time, and hold the logits to the full forward's."""
    _, cfg, _, tp = _model_setup(name)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    full, _, _ = M.forward(cfg, tp, toks)
    _, cache = M.prefill(cfg, tp, toks[:, :8], capacity=16)
    outs = []
    for i in range(8, 16):
        li, cache = M.decode_step(cfg, tp, cache, toks[:, i:i + 1])
        outs.append(li)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 8:].numpy(), rtol=2e-2, atol=2e-2)
