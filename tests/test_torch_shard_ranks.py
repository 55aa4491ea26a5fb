"""The port's sharding on real ranks: CPU processes joined in a gloo group,
against the JAX package's sharding on the 8 virtual host devices
``conftest.py`` forces (a concrete ``jax.sharding.Mesh``, whose axes are
Auto; ``jax.make_mesh`` builds Explicit ones, ROADMAP Queue 3).

Ranks are spawned once per mesh shape (2 x 2 and 1 x 4, helpers in
``_torch_ranks.py``); each runs every case of its shape and returns numpy.

  local_shard  each rank's block, and ``distribute_tensor``'s, equal the
               reference's ``addressable_shards`` exactly (two axes on one
               dim included; DTensor splits them in mesh order only, so a
               spec naming them in another order has no placements);
  constrain    a DTensor comes back with the placements of the reference's
               ``constrain(x).sharding.spec``, its values unchanged;
  MoE          ``_moe_apply_shard_map`` on the whole inputs, each rank on
               its block: the output, the aux loss and the gradients
               (summed over the ranks) against the reference's shard_map
               branch on the same mesh shape, and against the port's
               one-rank ``moe_apply`` (its aux loss averaged over the data
               shards, as the branch averages it). Three cases: plain
               (qwen2-moe-a2.7b reduced, 2 x 2), padding (6 experts on
               1 x 4: 8 slots, the last rank's 2 experts zero) and
               sequence-parallel (llama4-scout-17b-a16e reduced, 2 x 2:
               the sequence gathered on entry, the output reduce-scattered).
               Tolerances: the output within 1e-5 (fp32) / 2**-5 (bf16)
               of its largest magnitude; each gradient within 1e-5 / 2**-5
               of the largest gradient magnitude of the case (a top-1
               router's gradient comes from the aux loss alone, about 1e-3
               of the others: its gate normalises to 1, whose derivative
               cancels only up to rounding of the larger terms); the aux
               loss within 1e-5 relative. Measured gaps: fp32 at most 5e-7
               (output) and 3e-7 (gradients; 1.8e-4 of the llama4 router's
               own scale against the reference, 1.6e-7 against the port's
               one-rank path); bf16 at most 0.0087 and 0.0084 (each rank's
               partial sums round to bf16 before the collective; the
               reference's own bf16 branch is 0.015625 off its unsharded
               output); the aux loss at most 1.2e-7.
  dist_agg     ``fuse_sharded`` on 2 x 2 equals ``fused_agg_ref`` on the
               whole stack and the reference's ``fused_agg`` in interpret
               mode, with no collective counted (a gloo ``all_reduce``
               counts one, so the counter sees them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from _torch_ranks import (AUX_W, CONSTRAIN_CASES, LOCAL_SPECS, MOE_CASES,
                          fuse_inputs, moe_config, moe_inputs, run_ranks)
from repro import configs as jconfigs
from repro.kernels.fused_agg import fused_agg as jfused_agg
from repro.launch import sharding as jshd
from repro.models import moe as jmoe
from repro.models import sharding_ctx as jctx
from repro_torch import tree_leaves, tree_map
from repro_torch.kernels.ref import fused_agg_ref
from repro_torch.launch.sharding import NamedSharding
from repro_torch.models import moe
from repro_torch.models.spec import DTYPES

jconfigs.load_all()
torch.set_num_threads(1)

DTYPE_NAMES = ["float32", "bfloat16"]
TOL = {"float32": {"y": 1e-5, "grad": 1e-5, "aux": 1e-5},
       "bfloat16": {"y": 2.0 ** -5, "grad": 2.0 ** -5, "aux": 1e-5}}


def _moe_keys(shape):
    return [(f"{c}-{d}", c, d) for c, (_, _, s) in MOE_CASES.items()
            if s == shape for d in DTYPE_NAMES]


@pytest.fixture(scope="module")
def ranks_2x2(tmp_path_factory):
    cases = [("local_shard", "local_shard", {}),
             ("constrain", "constrain", {}), ("fuse", "fuse", {})]
    cases += [(k, "moe", {"case": c, "dtype": d})
              for k, c, d in _moe_keys((2, 2))]
    return run_ranks((2, 2), cases, tmp_path_factory.mktemp("ranks_2x2"))


@pytest.fixture(scope="module")
def ranks_1x4(tmp_path_factory):
    cases = [(k, "moe", {"case": c, "dtype": d})
             for k, c, d in _moe_keys((1, 4))]
    return run_ranks((1, 4), cases, tmp_path_factory.mktemp("ranks_1x4"))


def _jmesh(shape):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))


def _shard_of(placed, jmesh, coords):
    """The reference's shard on the device at mesh ``coords``."""
    dev = jmesh.devices[tuple(coords)]
    (s,) = [s for s in placed.addressable_shards if s.device == dev]
    return np.asarray(s.data)


def test_ranks_sit_at_their_mesh_coordinates(ranks_2x2, ranks_1x4):
    assert [ranks_2x2[r]["coords"] for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [ranks_1x4[r]["coords"] for r in range(4)] == [
        (0, 0), (0, 1), (0, 2), (0, 3)]


@pytest.mark.parametrize("i", range(len(LOCAL_SPECS)),
                         ids=[str(s) for s in LOCAL_SPECS])
def test_local_shard_on_ranks_equals_reference(ranks_2x2, i):
    jmesh = _jmesh((2, 2))
    arr = np.random.default_rng(7).standard_normal((8, 12))
    arr = arr.astype(np.float32)
    placed = jax.device_put(arr, JNamedSharding(jmesh, P(*LOCAL_SPECS[i])))
    for r, res in ranks_2x2.items():
        mine, dtensor = res["local_shard"][i]
        want = _shard_of(placed, jmesh, res["coords"])
        np.testing.assert_array_equal(mine, want)
        if LOCAL_SPECS[i] == (None, ("model", "data")):
            assert dtensor is None  # placements() refused it
        else:
            np.testing.assert_array_equal(dtensor, want)


@pytest.mark.parametrize("i", range(len(CONSTRAIN_CASES)),
                         ids=[f"{a}-{s}-sp{sp}" for a, s, sp in
                              CONSTRAIN_CASES])
def test_constrain_on_ranks_takes_the_reference_s_layout(ranks_2x2, i):
    axes, shape, sp = CONSTRAIN_CASES[i]
    jmesh = _jmesh((2, 2))
    arr = np.random.default_rng(i).standard_normal(shape).astype(np.float32)
    with jctx.activation_sharding(jmesh, jshd.activation_rules(jmesh, sp),
                                  profile="optimized"):
        y = jctx.constrain(jnp.asarray(arr), axes)
    spec = tuple(y.sharding.spec) + (None,) * (len(shape)
                                               - len(y.sharding.spec))
    want = tuple(str(p) for p in NamedSharding(
        {"data": 2, "model": 2}, spec).placements())
    for r, res in ranks_2x2.items():
        placements, local, full = res["constrain"][i]
        assert placements == want
        np.testing.assert_array_equal(full, arr)
        np.testing.assert_array_equal(local,
                                      _shard_of(y, jmesh, res["coords"]))


def _rel(got, want, scale=None):
    """The largest gap over ``scale`` (default: want's largest magnitude)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if scale is None:
        scale = float(np.max(np.abs(want)))
    return float(np.max(np.abs(got - want))) / scale


def _reference_moe(case, dtype):
    """The reference's shard_map branch on the case's mesh shape: output,
    aux loss, gradients of sum(y * ct) + AUX_W * aux (weights in
    jax.tree order, then x), all fp32 numpy."""
    name, over, shape = MOE_CASES[case]
    jcfg = jconfigs.get_config(name).reduced(dtype=dtype, **over)
    p_np, x_np, ct_np = moe_inputs(jcfg.d_model, jcfg.d_ff, jcfg.num_experts,
                                   jcfg.d_ff * jcfg.num_shared_experts)
    dt = jnp.dtype(dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a).astype(dt), p_np)
    x = jnp.asarray(x_np).astype(dt)
    ct = jnp.asarray(ct_np)

    def objective(p, x):
        y, aux = jmoe.moe_apply(jcfg, p, x)
        return (jnp.sum(y.astype(jnp.float32) * ct)
                + AUX_W * aux.astype(jnp.float32)), (y, aux)

    jmesh = _jmesh(shape)
    rules = jshd.activation_rules(jmesh, jcfg.sequence_parallel)
    with jctx.activation_sharding(jmesh, rules, profile="optimized"):
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(p, x)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return (f32(y), float(aux), [f32(g) for g in jax.tree.leaves(gp)],
            f32(gx))


def _one_rank_moe(case, dtype):
    """The port's one-rank ``moe_apply`` on the whole inputs, its aux loss
    averaged over the case's data shards."""
    _, _, (dp, _) = MOE_CASES[case]
    cfg = moe_config(case, dtype)
    p_np, x_np, ct_np = moe_inputs(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                   cfg.d_ff * cfg.num_shared_experts)
    dt = DTYPES[dtype]
    p = tree_map(lambda a: torch.from_numpy(a).to(dt).requires_grad_(), p_np)
    x = torch.from_numpy(x_np).to(dt).requires_grad_()
    y, _ = moe.moe_apply(cfg, p, x)
    aux = sum(moe.moe_apply(cfg, p, xd)[1] for xd in torch.chunk(x, dp)) / dp
    (y.float() * torch.from_numpy(ct_np)).sum().add(AUX_W * aux).backward()
    return (y.detach().float().numpy(), float(aux.detach()),
            [g.grad.float().numpy() for g in tree_leaves(p)],
            x.grad.float().numpy())


def _assemble(results, key, case):
    """The branch's global output, aux loss and summed gradients from the
    ranks' results: each rank's block placed at its coordinates (blocks
    held alike by several ranks must agree), gradients summed in rank
    order."""
    cfg = moe_config(case, "float32")
    _, _, shape = MOE_CASES[case]
    first = results[0][key]
    b = first["x"].shape[0]
    y = np.full((b,) + first["x"].shape[1:], np.nan, np.float32)
    for res in results.values():
        d, j = res["coords"]
        blk = res[key]["y"]
        rows = slice(d * blk.shape[0], (d + 1) * blk.shape[0])
        cols = (slice(j * blk.shape[1], (j + 1) * blk.shape[1])
                if cfg.sequence_parallel else slice(None))
        if not np.isnan(y[rows, cols]).all():
            np.testing.assert_array_equal(y[rows, cols], blk)
        y[rows, cols] = blk
    assert not np.isnan(y).any()
    auxes = {res[key]["aux"] for res in results.values()}
    assert len(auxes) == 1  # every rank holds the same averaged aux
    grads = [sum(res[key]["grads"][i] for res in results.values())
             for i in range(len(first["grads"]))]
    gx = sum(res[key]["x"] for res in results.values())
    return y, auxes.pop(), grads, gx


def _check_moe(results, case, dtype):
    key = f"{case}-{dtype}"
    tol = TOL[dtype]
    got = _assemble(results, key, case)
    for want in (_reference_moe(case, dtype), _one_rank_moe(case, dtype)):
        assert _rel(got[0], want[0]) <= tol["y"]
        assert abs(got[1] - want[1]) <= tol["aux"] * abs(want[1])
        assert len(got[2]) == len(want[2])
        grads = list(zip(got[2] + [got[3]], want[2] + [want[3]]))
        scale = max(float(np.max(np.abs(w))) for _, w in grads)
        for g, w in grads:
            assert _rel(g, w, scale) <= tol["grad"]


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("case", ["qwen2-moe", "llama4-sp"])
def test_moe_branch_on_2x2_matches_reference(ranks_2x2, case, dtype):
    _check_moe(ranks_2x2, case, dtype)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_moe_branch_pads_experts_on_1x4(ranks_1x4, dtype):
    cfg = moe_config("qwen2-moe-pad", dtype)
    assert cfg.num_experts == 6  # 8 slots over 4 ranks: rank 3's are zero
    _check_moe(ranks_1x4, "qwen2-moe-pad", dtype)


def test_fuse_sharded_on_2x2_runs_collective_free(ranks_2x2):
    stack, w = fuse_inputs()
    want = fused_agg_ref(torch.from_numpy(stack), torch.from_numpy(w))
    jwant = np.asarray(jfused_agg(jnp.asarray(stack), jnp.asarray(w),
                                  interpret=True))
    got = np.zeros(stack.shape[1], np.float32)
    for res in ranks_2x2.values():
        f = res["fuse"]
        assert f["collectives"] == 0
        assert f["control"] >= 1
        assert f["placements"] == ("S(0)", "S(0)")
        assert f["global_shape"] == (stack.shape[1],)
        d, j = res["coords"]
        n = len(f["local"])
        got[(2 * d + j) * n:(2 * d + j + 1) * n] = f["local"]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, jwant, rtol=1e-6, atol=1e-7)
