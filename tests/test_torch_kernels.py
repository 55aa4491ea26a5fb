"""The port's fusion kernels against the JAX package's, on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version, so these tests
hold the port's plain versions and tree-level wrappers against the Pallas
kernels (interpret mode) and the reference's oracles on the same numpy
inputs. The CUDA kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``.

Tolerances: pair_fuse's mean, max and min agree bit for bit. Its wsum
(wa*a + wb*b) may be contracted into one fused multiply-add by XLA, while
the port rounds each product (as the CUDA kernel does), so the two differ
by at most one fp32 rounding of the terms, 2**-23 * (|wa*a| + |wb*b|); a
bf16 output may then round to the neighbouring bf16 value, 2**-7 of the
same scale. fused_agg sums K products in an order each framework picks: fp32 outputs
agree within rtol 1e-5 (a few fp32 ulps over K <= 17 terms), and a bf16
output may round to a neighbouring bf16 value, so bf16 agrees within one
bf16 ulp (rtol 2**-7).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_agg import fused_agg as j_fused_agg
from repro.kernels.pair_fuse import pair_fuse as j_pair_fuse
from repro_torch.kernels import accumulate, build, fuse_updates
from repro_torch.kernels.fused_agg import fused_agg
from repro_torch.kernels.pair_fuse import pair_fuse, pair_fuse_many

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0 ** -7


def _pair(x: np.ndarray, dt: str):
    """The same values in both frameworks (both cast fp32->bf16 to nearest
    even)."""
    jdt, tdt = DT[dt]
    return jnp.asarray(x, jnp.float32).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("n", [1000, 8193])
@pytest.mark.parametrize("dts", [("f32", "f32"), ("bf16", "bf16"),
                                 ("f32", "bf16")])
@pytest.mark.parametrize("op", ["mean", "wsum", "max", "min"])
def test_pair_fuse_matches_pallas(op, dts, n):
    rng = np.random.default_rng(n)
    ja, ta = _pair(rng.standard_normal(n, dtype=np.float32), dts[0])
    jb, tb = _pair(rng.standard_normal(n, dtype=np.float32), dts[1])
    want = j_pair_fuse(ja, jb, op=op, wa=0.3, wb=0.7, interpret=True)
    got = pair_fuse(ta, tb, op=op, wa=0.3, wb=0.7)
    assert got.dtype == ta.dtype and got.shape == (n,)
    for w in (want, jref.pair_fuse_ref(ja, jb, op, 0.3, 0.7)):
        if op == "wsum":
            _assert_wsum_close(got, w, 0.3 * _np(ta), 0.7 * _np(tb))
        else:
            np.testing.assert_array_equal(_np(got), _np(w))


def _assert_wsum_close(got, want, *terms):
    ulp = 2.0 ** -23 if got.dtype == torch.float32 else BF16_ULP
    bound = ulp * sum(np.abs(t) for t in terms)
    assert np.all(np.abs(_np(got) - _np(want)) <= bound)


@pytest.mark.parametrize("op", ["mean", "wsum", "max", "min"])
def test_pair_fuse_many_matches_pallas(op):
    """The fold's entry point, many pairs of leaves of any rank (an empty one
    among them) and the three dtype pairs in one call, each leaf against the
    Pallas kernel on the flattened pair, at the tolerances above."""
    rng = np.random.default_rng(7)
    shapes = [(1000,), (3, 33), (0,), (2, 5, 7), (8193,)]
    dts = [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")]
    js, ts = [], []
    for i, shape in enumerate(shapes):
        da, db = dts[i % 3]
        ja, ta = _pair(rng.standard_normal(shape, dtype=np.float32), da)
        jb, tb = _pair(rng.standard_normal(shape, dtype=np.float32), db)
        js.append((ja, jb))
        ts.append((ta, tb))
    got = pair_fuse_many([a for a, _ in ts], [b for _, b in ts], op=op,
                         wa=0.3, wb=0.7)
    assert len(got) == len(shapes)
    for (ja, jb), (ta, tb), g in zip(js, ts, got):
        assert g.dtype == ta.dtype and g.shape == ta.shape
        if ta.numel() == 0:
            continue
        want = j_pair_fuse(ja.reshape(-1), jb.reshape(-1), op=op, wa=0.3,
                           wb=0.7, interpret=True)
        flat = g.reshape(-1)
        if op == "wsum":
            _assert_wsum_close(flat, want, 0.3 * _np(ta).reshape(-1),
                               0.7 * _np(tb).reshape(-1))
        else:
            np.testing.assert_array_equal(_np(flat), _np(want))
        # each leaf is the bits of pair_fuse on its own flattened pair
        assert torch.equal(flat, pair_fuse(ta.reshape(-1), tb.reshape(-1),
                                           op=op, wa=0.3, wb=0.7))


def test_pair_fuse_many_rejects_what_it_does_not_take():
    one = torch.ones(4)
    assert pair_fuse_many([], []) == []
    with pytest.raises(ValueError):
        pair_fuse_many([one], [one, one])
    with pytest.raises(ValueError):
        pair_fuse_many([one, one], [one, torch.ones(5)])
    with pytest.raises(ValueError):
        pair_fuse_many([one], [one], op="sum")
    with pytest.raises(ValueError):
        pair_fuse_many([one], [one], bn=3000, kb=8)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="not all on"):
        pair_fuse_many([one, meta], [one, meta])
    with pytest.raises(ValueError, match="cuda or cpu"):
        pair_fuse_many([meta], [meta])


@pytest.mark.parametrize("k,n", [(3, 1000), (17, 3001)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_agg_matches_pallas(k, n, dt):
    rng = np.random.default_rng(k * 1000 + n)
    ju, tu = _pair(rng.standard_normal((k, n), dtype=np.float32), dt)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    want = j_fused_agg(ju, jnp.asarray(w), interpret=True)
    got = fused_agg(tu, torch.from_numpy(w))
    assert got.dtype == tu.dtype and got.shape == (n,)
    rtol = 1e-5 if dt == "f32" else BF16_ULP
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(
        _np(got), _np(jref.fused_agg_ref(ju, jnp.asarray(w))),
        rtol=rtol, atol=1e-6)


def _trees(k, dt, seed=0, shapes=((8, 4), (16,), (2, 3, 5))):
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for _ in range(k):
        leaves = {f"w{j}": _pair(rng.standard_normal(s, dtype=np.float32), dt)
                  for j, s in enumerate(shapes)}
        js.append({n: p[0] for n, p in leaves.items()})
        ts.append({n: p[1] for n, p in leaves.items()})
    return js, ts


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tree_ops_match_reference(dt):
    js, ts = _trees(3, dt)
    weights = [0.2, 0.5, 0.3]
    want = jops.fuse_updates(js, weights, interpret=True)
    got = fuse_updates(ts, weights)
    rtol = 1e-5 if dt == "f32" else BF16_ULP
    for key in want:
        assert got[key].shape == tuple(want[key].shape)
        assert got[key].dtype == DT[dt][1]
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), rtol=rtol,
                                   atol=1e-6)
    # streaming: fold all three into the fp32 accumulator
    jacc = tacc = None
    for ju, tu, w in zip(js, ts, weights):
        jacc = jops.accumulate(jacc, ju, w, interpret=True)
        tacc = accumulate(tacc, tu, w)
    # each of the two pair_fuse folds may differ by one rounding
    terms = {key: 2 * sum(np.abs(w * _np(t[key])) for t, w in zip(ts, weights))
             for key in jacc}
    for key in jacc:
        assert tacc[key].dtype == torch.float32
        _assert_wsum_close(tacc[key], jacc[key], terms[key])


def test_accumulate_is_out_of_place():
    _, ts = _trees(2, "bf16", seed=1)
    acc = accumulate(None, ts[0], 2.0)
    before = {k: v.clone() for k, v in acc.items()}
    new = accumulate(acc, ts[1], 3.0)
    for k in acc:
        assert torch.equal(acc[k], before[k])  # the old partial is intact
        assert new[k].data_ptr() != acc[k].data_ptr()


def test_cpu_calls_are_not_kernel_launches():
    p0, f0 = (pair_fuse.launches, pair_fuse.pairs), fused_agg.launches
    pair_fuse(torch.ones(5), torch.ones(5), op="wsum")
    pair_fuse_many([torch.ones(5), torch.ones(2, 3)],
                   [torch.ones(5), torch.ones(2, 3)], op="wsum")
    fused_agg(torch.ones(2, 5), torch.ones(2))
    assert ((pair_fuse.launches, pair_fuse.pairs),
            fused_agg.launches) == (p0, f0)


def test_wrappers_reject_what_they_do_not_take():
    with pytest.raises(ValueError):
        pair_fuse(torch.ones(4), torch.ones(5))
    with pytest.raises(ValueError):
        pair_fuse(torch.ones(4), torch.ones(4), op="sum")
    with pytest.raises(ValueError):
        fused_agg(torch.ones(3, 4), torch.ones(2))
    with pytest.raises(ValueError):
        fused_agg(torch.ones(0, 4), torch.ones(0))
    # a tensor on neither the card nor the CPU never reaches a plain version
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pair_fuse(meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_agg(meta.reshape(1, 4), torch.empty(1, device="meta"))


def test_sources_export_what_the_bindings_load():
    """Each CUDA source defines the C launch function its ctypes binding
    declares, with as many parameters, built for sm_90a."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name, (fn, argtypes) in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, f"{name}.cu does not export {fn}"
        assert len(m.group(1).split(",")) == len(argtypes)
        assert "cudaGetLastError" in src

