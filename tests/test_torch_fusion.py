"""The port's fusion algorithms and aggregation executor against the JAX
package's, on the same numpy-seeded update trees, on the CPU.

Tolerances: everything here is fp32. The fold (pair_fuse wsum) and the batch
fuse (fused_agg) sum in other orders, and XLA may contract a product into a
fused multiply-add where the port rounds it: all within rtol 1e-5 / atol
1e-6, a few fp32 ulps over at most 8 terms. Linearity properties within the
port (order, merge, checkpoint/resume) are held to the same bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.queue import MessageQueue as JQueue
from repro.fl import aggregator as jagg
from repro.fl import fusion as jfusion
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.aggregator import AggregationExecutor
from repro_torch.fl.fusion import FedAvg, FedProx, FedSGD, FusionState, get_algorithm

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = ((8, 4), (16,), (2, 3, 5))


def _updates(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{f"w{j}": rng.standard_normal(s, dtype=np.float32)
             for j, s in enumerate(SHAPES)} for _ in range(k)]


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(a, b, **tol):
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32),
                                   **(tol or TOL))


def _fold_all(ups, ws, order=None):
    st = FusionState()
    for i in order or range(len(ups)):
        st = st.fold(_t(ups[i]), ws[i])
    return st


@pytest.mark.parametrize("alg", ["fedavg", "fedprox", "fedsgd"])
def test_fuse_matches_reference_and_closed_form(alg):
    ups, n_ex = _updates(4), [10, 20, 30, 40]
    got = get_algorithm(alg).fuse([_t(u) for u in ups], n_ex)
    want = jfusion.get_algorithm(alg).fuse([_j(u) for u in ups], n_ex,
                                           interpret=True)
    _close(got, want)
    closed = {k: sum(n * u[k] for n, u in zip(n_ex, ups)) / sum(n_ex)
              for k in ups[0]}
    _close(got, closed)


def test_fedsgd_apply_matches_reference():
    model = {"w": np.ones((4, 4), np.float32)}
    grads = [{"w": np.full((4, 4), 2.0, np.float32)},
             {"w": np.full((4, 4), 4.0, np.float32)}]
    got = FedSGD().apply(_t(model), FedSGD().fuse([_t(g) for g in grads],
                                                  [1, 1]), lr=0.1)
    want = jfusion.FedSGD().apply(
        _j(model), jfusion.FedSGD().fuse([_j(g) for g in grads], [1, 1]),
        lr=0.1)
    _close(got, want)
    np.testing.assert_allclose(got["w"].numpy(), 1.0 - 0.1 * 3.0, rtol=1e-6)


def test_fedprox_server_side_equals_fedavg():
    ups, n_ex = [_t(u) for u in _updates(3)], [5, 5, 10]
    _close(FedProx().fuse(ups, n_ex), FedAvg().fuse(ups, n_ex))


@pytest.mark.parametrize("k", [2, 5, 8])
def test_incremental_equals_batch_and_order_free(k):
    ups = _updates(k, seed=k)
    ws = [float(i + 1) for i in range(k)]
    inc = _fold_all(ups, ws).result()
    batch = FedAvg().fuse([_t(u) for u in ups], [int(w) for w in ws])
    _close(inc, batch)
    order = list(np.random.default_rng(k).permutation(k))
    _close(_fold_all(ups, ws, order).result(), inc)
    # and the reference's fold gives the same partial aggregate
    jst = jfusion.FusionState()
    for u, w in zip(ups, ws):
        jst = jst.fold(_j(u), w, interpret=True)
    _close(inc, jst.result())


def test_parallel_merge_equals_sequential_and_reference():
    ups, n_ex = _updates(5, seed=3), [10, 20, 30, 40, 50]
    a1 = AggregationExecutor("j", "fedavg", n_workers=1).aggregate(
        [_t(u) for u in ups], n_ex)
    a3 = AggregationExecutor("j", "fedavg", n_workers=3).aggregate(
        [_t(u) for u in ups], n_ex)
    _close(a3, a1)
    want = jagg.AggregationExecutor("j", "fedavg", n_workers=3).aggregate(
        [_j(u) for u in ups], n_ex)
    _close(a3, want)


def _publish(q, ups, job="job"):
    for i, u in enumerate(ups):
        q.publish_update(job, f"p{i}", u, round_idx=0, n_examples=10 * (i + 1))


def test_checkpoint_resume_matches_reference():
    ups = _updates(4, seed=5)
    gm = {k: np.zeros_like(v) for k, v in ups[0].items()}
    results = []
    for Q, Agg, conv in [(MessageQueue, AggregationExecutor, _t),
                         (JQueue, jagg.AggregationExecutor, _j)]:
        q = Q()
        _publish(q, [conv(u) for u in ups])
        agg = Agg("job", "fedavg", q)
        assert agg.drain(0, max_messages=2) == 2
        agg.checkpoint()
        agg2 = Agg("job", "fedavg", q)  # preempted: a NEW executor resumes
        assert agg2.resume()
        assert agg2.drain(0) == 2
        results.append(agg2.finish_round(conv(gm), 0))
        assert len(q.topic("fused/job")) == 1
    _close(results[0], results[1])
    n_ex = [10, 20, 30, 40]
    closed = {k: sum(n * u[k] for n, u in zip(n_ex, ups)) / sum(n_ex)
              for k in ups[0]}
    _close(results[0], closed)


def test_folding_never_changes_a_checkpointed_partial():
    ups = _updates(4, seed=7)
    q = MessageQueue()
    _publish(q, [_t(u) for u in ups])
    agg = AggregationExecutor("job", "fedavg", q)
    agg.drain(0, max_messages=2)
    agg.checkpoint()
    snap = q.latest_partial("job")
    frozen = {k: v.clone() for k, v in snap["acc"].items()}
    agg.drain(0)  # folds two more into the live state
    assert agg.state.n_fused == 4 and snap["n_fused"] == 2
    for k in frozen:
        assert torch.equal(snap["acc"][k], frozen[k])
    # resuming from the snapshot redoes the second half exactly
    agg2 = AggregationExecutor("job", "fedavg", q, group="replay")
    assert agg2.resume()
    for i in (2, 3):
        agg2.state = agg2.state.fold(_t(ups[i]), 10.0 * (i + 1))
    _close(agg2.state.result(), agg.state.result(), rtol=0, atol=0)
