"""The port's int8 quantised-update path against the JAX package's, on the
CPU: ``quant_agg`` (its plain version, which a CPU tensor takes), the
party-side ``quantize``, the tree wrappers ``quantize_update`` and
``fuse_quantized``, and the ``serve_quantized`` example, on the same
numpy-seeded inputs. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.

Tolerances: ``quantize`` is exact in both packages (a max, one true fp32
division, round half to even, a clip), so ``q`` and the scale must agree bit
for bit. ``quant_agg`` sums K fp32 products in an order each framework
picks, so fused values may differ by K fp32 roundings of
sum_k |s_k q_kn|. A bf16 output of ``fuse_updates`` may round to the
neighbouring bf16 value, so errors measured against it agree within one
bf16 ulp (2**-7) of the leaf's largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.jobspec import FLJobSpec as JFLJobSpec
from repro.core.jobspec import PartySpec as JPartySpec
from repro.core.prediction import UpdatePredictor as JUpdatePredictor
from repro.kernels import fuse_quantized as j_fuse_quantized
from repro.kernels import fuse_updates as j_fuse_updates
from repro.kernels import quantize_update as j_quantize_update
from repro.kernels import ref as jref
from repro.kernels.quant_agg import quant_agg as j_quant_agg
from repro.kernels.quant_agg import quantize as j_quantize
from repro.models import model as JM
from repro_torch import configs, interop, tree_leaves
from repro_torch.examples import serve_quantized
from repro_torch.kernels import fuse_quantized, quantize_update
from repro_torch.kernels.quant_agg import quant_agg, quantize

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_sum_close(got, want, q, s):
    """Within K fp32 roundings of sum_k |s_k q_kn| (q: (K, N), s: (K,))."""
    scale = np.abs(s.astype(np.float64)) @ np.abs(q.astype(np.float64))
    bound = q.shape[0] * 2.0 ** -23 * scale
    assert np.all(np.abs(_np(got).astype(np.float64) - _np(want)) <= bound)


def _qs(k, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    s = rng.uniform(1e-4, 1.0, size=k).astype(np.float32)
    return q, s


@pytest.mark.parametrize("k,n", [(1, 1000), (5, 1500), (33, 4097), (40, 8192)])
def test_quant_agg_matches_pallas(k, n):
    q, s = _qs(k, n, seed=k * 10_000 + n)
    got = quant_agg(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (n,)
    for want in (j_quant_agg(jnp.asarray(q), jnp.asarray(s), interpret=True),
                 jref.quant_agg_ref(jnp.asarray(q), jnp.asarray(s))):
        _assert_sum_close(got, want, q, s)


def _quantize_inputs(case: str):
    rng = np.random.default_rng(7)
    if case == "zeros":
        return np.zeros(1000, np.float32), "f32"
    if case == "tiny":
        return (rng.standard_normal(1000) * 1e-30).astype(np.float32), "f32"
    dt = "bf16" if case.startswith("bf16") else "f32"
    mag = 10.0 ** rng.uniform(-4, 2)
    return (rng.standard_normal(20_003) * mag).astype(np.float32), dt


@pytest.mark.parametrize("case", ["f32", "bf16", "zeros", "tiny"])
def test_quantize_matches_reference_exactly(case):
    x, dt = _quantize_inputs(case)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dt == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = j_quantize(jx)
    q, s = quantize(tx)
    assert q.dtype == torch.int8 and q.shape == (x.size,)
    assert s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    if case == "zeros":
        assert float(s) == 1.0


def _reduced_updates():
    """Three bf16 updates of a reduced qwen3-0.6b from the reference's init
    (as ``tests/test_system.py`` makes them), in both packages."""
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(
        num_layers=2, d_model=64, vocab_size=128)
    gp = JM.init(jcfg, jax.random.PRNGKey(0))
    jups = [jax.tree.map(lambda p, i=i: p * (1 + 0.02 * i), gp)
            for i in range(3)]
    tups = [interop.to_torch(jax.tree.map(np.asarray, u), "cpu") for u in jups]
    return jups, tups


def test_tree_quantisation_matches_reference():
    jups, tups = _reduced_updates()
    w = [0.5, 0.3, 0.2]
    jq, js = zip(*(j_quantize_update(u) for u in jups))
    tq, ts = zip(*(quantize_update(u) for u in tups))
    for a, b in zip(jq, tq):
        for ja, tb in zip(jax.tree.leaves(a), tree_leaves(b), strict=True):
            assert tb.dtype == torch.int8
            np.testing.assert_array_equal(tb.numpy(), np.asarray(ja))
    for a, b in zip(js, ts):
        for ja, tb in zip(jax.tree.leaves(a), tree_leaves(b), strict=True):
            assert tb.numpy().tobytes() == np.asarray(ja).tobytes()
    want = j_fuse_quantized(list(jq), list(js), w, interpret=True)
    got = fuse_quantized(list(tq), list(ts), w)
    for i, (jl, tl) in enumerate(zip(jax.tree.leaves(want), tree_leaves(got),
                                     strict=True)):
        assert tl.dtype == torch.float32 and tl.shape == tuple(jl.shape)
        q = np.stack([tree_leaves(u)[i].numpy().reshape(-1) for u in tq])
        s = np.asarray([float(tree_leaves(ss)[i]) * wk
                        for ss, wk in zip(ts, w)], np.float32)
        _assert_sum_close(tl.reshape(-1), np.asarray(jl).reshape(-1), q, s)


def test_row_scale_is_a_double_product_cast_once():
    """scale * weight is taken in Python doubles, then cast to fp32, as the
    reference does; an fp32 product would round differently here."""
    w = 0.1
    cands = np.random.default_rng(3).uniform(1e-3, 1.0, 1000).astype(np.float32)
    s = next(c for c in cands
             if np.float32(float(c) * w) != np.float32(c) * np.float32(w))
    q = {"w": torch.ones(4, dtype=torch.int8)}
    got = fuse_quantized([q], [{"w": torch.tensor(s)}], [w])["w"]
    want = j_fuse_quantized([{"w": jnp.ones(4, jnp.int8)}],
                            [{"w": jnp.asarray(s)}], [w], interpret=True)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].item() == float(np.float32(float(s) * w))


def _reference_example(jcfg):
    """The body of the reference's ``examples/serve_quantized.py``: its
    updates, per-leaf errors and bounds, max |exact| per leaf, and t_upd."""
    key = jax.random.PRNGKey(0)
    updates = [
        jax.tree.map(
            lambda p, k=k: p + 0.01 * jax.random.normal(
                jax.random.PRNGKey(k), p.shape, jnp.float32
            ).astype(p.dtype),
            JM.init(jcfg, key),
        )
        for k in range(4)
    ]
    weights = serve_quantized.WEIGHTS
    exact = j_fuse_updates(updates, weights)
    qs, ss = zip(*(j_quantize_update(u) for u in updates))
    fused_q = j_fuse_quantized(list(qs), list(ss), weights)
    errs = [float(jnp.max(jnp.abs(a.astype(jnp.float32) - b)))
            for a, b in zip(jax.tree.leaves(exact), jax.tree.leaves(fused_q))]
    bounds = [sum(w * float(jnp.max(s_leaf))
                  for w, s_leaf in zip(weights, leaves))
              for leaves in zip(*(jax.tree.leaves(s) for s in ss))]
    peaks = [float(jnp.max(jnp.abs(a.astype(jnp.float32))))
             for a in jax.tree.leaves(exact)]
    n_bytes = JM.n_params(jcfg) * 4
    spec = JFLJobSpec(
        job_id="q", model_arch=jcfg.name, model_bytes=n_bytes,
        parties={"p0": JPartySpec("p0", epoch_time_s=60.0, bw_up=5e6,
                                  bw_down=5e6)})
    t_fp32 = JUpdatePredictor(spec).t_upd("p0")
    spec.model_bytes = n_bytes // 4
    t_int8 = JUpdatePredictor(spec).t_upd("p0")
    return updates, errs, bounds, peaks, t_fp32, t_int8


def test_serve_quantized_matches_reference_example():
    kw = dict(num_layers=2, d_model=128, vocab_size=256)
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(**kw)
    cfg = configs.get_config("qwen3-0.6b").reduced(**kw)
    jups, errs, bounds, peaks, t_fp32, t_int8 = _reference_example(jcfg)
    tups = [interop.to_torch(jax.tree.map(np.asarray, u), "cpu") for u in jups]
    out = serve_quantized.compare(cfg, tups, serve_quantized.WEIGHTS)
    # the scales agree bit for bit and are summed in the same order
    assert out["bounds"] == bounds
    assert (out["t_upd_fp32"], out["t_upd_int8"]) == (t_fp32, t_int8)
    assert len(out["errs"]) == len(errs) == 14
    for e, je, peak in zip(out["errs"], errs, peaks, strict=True):
        assert abs(e - je) <= 2.0 ** -7 * peak + 1e-6


def test_serve_quantized_cli_runs_the_reduced_config(capsys):
    serve_quantized.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("max abs fusion error from int8 updates:")
    assert lines[1].startswith("t_upd fp32=") and "-> int8=" in lines[1]


def test_quant_wrapper_rejects_what_it_does_not_take():
    q, s = torch.ones(3, 8, dtype=torch.int8), torch.ones(3)
    with pytest.raises(TypeError):
        quant_agg(q.float(), s)
    with pytest.raises(TypeError):
        quant_agg(q, s.double())
    with pytest.raises(ValueError):
        quant_agg(q, torch.ones(2))
    with pytest.raises(ValueError):
        quant_agg(q.reshape(-1), s)
    with pytest.raises(ValueError):
        quant_agg(q[:0], s[:0])
    with pytest.raises(ValueError, match="contiguous"):
        quant_agg(q.t().contiguous().t(), s)
    meta = torch.empty(3, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        quant_agg(meta, s)
    with pytest.raises(ValueError, match="cuda or cpu"):
        quant_agg(meta, torch.empty(3, device="meta"))
    empty = quant_agg(q[:, :0].contiguous(), s)
    assert empty.dtype == torch.float32 and empty.shape == (0,)


def test_cpu_calls_are_not_kernel_launches():
    before = quant_agg.launches
    quant_agg(torch.ones(2, 5, dtype=torch.int8), torch.ones(2))
    fuse_quantized([{"w": torch.ones(3, dtype=torch.int8)}],
                   [{"w": torch.tensor(0.5)}])
    assert quant_agg.launches == before


def test_example_needs_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=1, d_model=32, vocab_size=64, d_ff=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_quantized.run(cfg)
