"""The MoE layer of the port (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU, piece by piece: routing
with ties, capacity, the dispatch tables with dropped tokens, the combine,
the layer and its aux loss, and the aux loss's gradient through the
rematerialised layers to the router. Configs and weights as in
``test_torch_families.py``: qwen2-moe-a2.7b (60 experts top-4, 4 shared)
and llama4-scout-17b-a16e (16 experts top-1, 1 shared) at d_model 64.

Tolerances, and why:
  integers  routing indices, capacities and the token tables (dropped
            tokens included): equal. Gate tables: equal in bf16, within
            1e-6 in fp32 (one softmax and one division).
  combine   given the same expert outputs, bit for bit in fp32 and bf16:
            both add each token's slots in ascending expert order.
  fp32      router probs and gates within 1e-6 (one softmax); the layer's
            output and the router's gradient within 1e-4 of their largest
            magnitude (sums in another order); aux losses rtol 1e-5.
  bf16      the layer's output within 2**-5 of its largest magnitude, as
            ``test_torch_model.py`` holds qwen3's logits (every product
            rounds to bf16 at places and in orders that differ); its aux
            loss within 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.models import moe
from _torch_families import (MOE, _batch, _cfgs, _close, _f32, _grads_port,
                             _params)

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def _moe_inputs(name, dtype="float32", seed=3, **over):
    jcfg, cfg = _cfgs(name, dtype, **over)
    tree, _, _ = _params(jcfg, seed=seed)
    p = jax.tree.map(lambda a: a[0], tree["stage0"]["b0_moe"]["ffn"])
    x = np.random.default_rng(seed).standard_normal((4, 32, 64))
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(jnp.bfloat16)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, p),
            interop.to_torch(p, "cpu"), jnp.asarray(x),
            interop.to_torch({"x": x}, "cpu")["x"])


@pytest.mark.parametrize("name", MOE)
def test_route_matches_reference_ties_included(name):
    """Top-4 of 60 and top-1 of 16, with the router's columns duplicated in
    pairs, so that every expert ties with its twin: the lower index wins,
    as jax.lax.top_k orders it."""
    jcfg, cfg, jp, tp, jx, tx = _moe_inputs(name)
    for router in (np.asarray(jp["router"]),
                   np.repeat(np.asarray(jp["router"])[:, ::2], 2, axis=1)):
        jprobs, jgate, jidx = jmoe._route(jcfg, jnp.asarray(router), jx)
        probs, gate, idx = moe._route(cfg, torch.from_numpy(router), tx)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   atol=1e-6)
        np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    # the twins tie exactly, so the test above saw ties
    assert bool((probs[..., ::2] == probs[..., 1::2]).all())
    if cfg.num_experts_per_tok > 1:
        assert bool((idx[..., 0] + 1 == idx[..., 1]).all())


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
@pytest.mark.parametrize("name", MOE)
def test_dispatch_tables_match_reference_with_drops(name, capacity_factor):
    jcfg, cfg, jp, tp, jx, tx = _moe_inputs(
        name, capacity_factor=capacity_factor)
    c = moe.capacity(cfg, 32)
    assert c == jmoe.capacity(jcfg, 32)
    _, jgate, jidx = jmoe._route(jcfg, jp["router"], jx)
    _, gate, idx = moe._route(cfg, tp["router"], tx)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jtable, jgt = jmoe._dispatch_tables(jgate, jidx, cfg.num_experts, c,
                                            jdt)
        table, gt, slot, keep = moe._dispatch_tables(gate, idx,
                                                     cfg.num_experts, c, dt)
        want_slot, want_keep = moe._slots(idx, cfg.num_experts, c)
        assert torch.equal(slot, want_slot) and torch.equal(keep, want_keep)
        np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
        assert gt.dtype == dt
        kept_j = np.asarray(jgt.astype(jnp.float32)) > 0
        np.testing.assert_array_equal(gt.float().numpy() > 0, kept_j)
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(jgt.astype(jnp.float32)),
                                   atol=1e-6 if dt == torch.float32 else 0)
    # tokens really dropped at the low factor: fewer kept slots than
    # (token, choice) pairs
    if capacity_factor < 1.0:
        assert int((gt.float() > 0).sum()) < idx.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_combine_equals_reference_scatter_add(name, dtype):
    """The port's gather-combine against the reference's scatter-add of the
    same expert outputs, dropped tokens included: bit for bit, since both
    add each token's slots in ascending expert order."""
    jcfg, cfg, jp, tp, jx, tx = _moe_inputs(name, dtype, capacity_factor=0.5)
    c = moe.capacity(cfg, 32)
    _, jgate, jidx = jmoe._route(jcfg, jp["router"], jx)
    jtable, jgt = jmoe._dispatch_tables(jgate, jidx, cfg.num_experts, c,
                                        jx.dtype)
    jout = jmoe._expert_ffn(jmoe._gather_tokens(jx, jtable), jp["w_gate"],
                            jp["w_up"], jp["w_down"], jgt)
    want = jmoe._scatter_combine(jx, jtable, jout)
    idx = torch.from_numpy(np.asarray(jidx)).long()
    slot, keep = moe._slots(idx, cfg.num_experts, c)
    assert not bool(keep.all())  # tokens were dropped
    got = moe._combine(interop.to_torch({"o": np.asarray(jout)}, "cpu")["o"],
                       slot, keep)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_gather_gradient_equals_reference(name, dtype):
    """The dispatch gather's gradient (a fixed-order combine of the slots'
    gradients, where ``torch.gather`` would scatter-add with atomics on the
    card) against the reference's, ``jax.vjp`` of its gather, for the same
    slot gradients, dropped tokens included: bit for bit, since both add
    each token's slots in ascending expert order. Slots that the dispatch
    leaves empty carry a zero gradient, as the expert FFN's zero gate
    gives them."""
    jcfg, cfg, jp, tp, jx, tx = _moe_inputs(name, dtype, capacity_factor=0.5)
    c = moe.capacity(cfg, 32)
    _, jgate, jidx = jmoe._route(jcfg, jp["router"], jx)
    jtable, jgt = jmoe._dispatch_tables(jgate, jidx, cfg.num_experts, c,
                                        jx.dtype)
    rng = np.random.default_rng(7)
    g = rng.standard_normal(tuple(jtable.shape) + (64,)).astype(np.float32)
    g = g * (np.asarray(jgt.astype(jnp.float32))[..., None] > 0)
    jg = jnp.asarray(g).astype(jx.dtype)
    _, vjp = jax.vjp(lambda x: jmoe._gather_tokens(x, jtable), jx)
    want = vjp(jg)[0]
    idx = torch.from_numpy(np.asarray(jidx)).long()
    slot, keep = moe._slots(idx, cfg.num_experts, c)
    assert not bool(keep.all())  # tokens were dropped
    table = torch.from_numpy(np.asarray(jtable)).long()
    x = tx.clone().requires_grad_(True)
    xg = moe._gather_tokens(x, table, slot, keep)
    np.testing.assert_array_equal(_f32(xg),
                                  _f32(jmoe._gather_tokens(jx, jtable)))
    (got,) = torch.autograd.grad(
        xg, x, interop.to_torch({"g": np.asarray(jg)}, "cpu")["g"])
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_and_aux_loss_match_reference(name, dtype):
    jcfg, cfg, jp, tp, jx, tx = _moe_inputs(name, dtype, capacity_factor=0.5)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    y, aux = moe.moe_apply(cfg, tp, tx)
    assert y.dtype == tx.dtype and tuple(y.shape) == tuple(jy.shape)
    rel = 1e-4 if dtype == "float32" else 2.0 ** -5
    _close(y, jy, rel)
    jprobs, _, jidx = jmoe._route(jcfg, jp["router"], jx)
    probs, _, idx = moe._route(cfg, tp["router"], tx)
    np.testing.assert_allclose(
        float(moe._aux_loss(probs, idx, cfg.num_experts)),
        float(jmoe._aux_loss(jprobs, jidx, jcfg.num_experts)), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("name", MOE)
def test_aux_loss_gradient_reaches_the_router_through_remat(name):
    """The aux loss leaves each checkpointed layer as a second output: its
    gradient alone reaches every layer's router, equal to the reference's,
    and nothing but the router and the layers below it."""
    jcfg, cfg = _cfgs(name)
    _, jp, tp = _params(jcfg, seed=2)
    jb, tb = _batch(seed=2)
    jg = jax.grad(lambda p: JM.loss_fn(jcfg, p, jb)[1]["aux"])(jp)
    aux, g = _grads_port(cfg, tp, tb, key="aux")
    assert float(aux) > 0
    jrouter = jg["stage0"]["b0_moe"]["ffn"]["router"]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    router = g[paths.index("['stage0']['b0_moe']['ffn']['router']")]
    assert router is not None and bool(router.abs().sum() > 0)
    _close(router, jrouter, 1e-4)
    assert bool((router[1].abs().sum(0) > 0).all())  # the top layer too
    # the head and the top layer's experts lie above every router
    for path, a, b in zip(paths, jax.tree.leaves(jg), g):
        if "lm_head" in path or "final_norm" in path:
            assert not np.asarray(a).any() and b is None
        elif "['ffn']" in path and "router" not in path:
            assert not np.asarray(a)[1].any() and not bool(b[1].any())
