"""``AggregationExecutor.drain`` folding a backlog ``FOLD_WIDTH`` updates a
``batch_fold`` launch, on the CPU: a drain of 1,000 messages over a 17-leaf
tree gives the streaming fold's bits and counts 125 launches of 1,000
updates (counted as the card launches them: ``plan``'s tables), with no
``pair_fuse`` launch; the width follows the backlog (a drain of one message
is one launch of one update); stale messages are dropped and committed; a
checkpoint taken between two drains keeps its partial while the later
drain updates its own accumulator in place."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.ops as ops
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.aggregator import FOLD_WIDTH, AggregationExecutor
from repro_torch.fl.fusion import FusionState
from repro_torch.kernels import build
from repro_torch.kernels.batch_fold import Operands, batch_fold, plan

torch.set_num_threads(1)

# 17 leaves, several tiny, as mamba2-130m's fold has them (smaller)
SHAPES = ((503, 8), (64,), (3, 5), (1,), (33, 7), (2, 2, 2), (96,), (11,),
          (4, 64), (640,), (5,), (7, 9), (128,), (2,), (31,), (8, 8), (3,))
JOB = "job"


def _pool(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{f"w{j:02d}": torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(torch.bfloat16)
        for j, s in enumerate(SHAPES)} for _ in range(k)]


@pytest.fixture
def counted(monkeypatch):
    """``batch_fold`` counting the launches and updates the card would
    (``plan``'s tables; the CPU's plain route counts none), and the calls
    of ``pair_fuse_many`` made meanwhile."""
    real_bf, real_pf = ops.batch_fold, ops.pair_fuse_many
    calls = {"pair_fuse_many": 0}

    def counting_bf(acc, updates, weights, **kw):
        launches = plan([Operands(u.dtype, u.numel(), 0, 0, ())
                         for u in updates[0]],
                        *build.DEFAULT_SHAPES["batch_fold"])
        batch_fold.launches += len(launches)
        batch_fold.updates += len(launches) * len(updates)
        return real_bf(acc, updates, weights, **kw)

    def counting_pf(*a, **kw):
        calls["pair_fuse_many"] += 1
        return real_pf(*a, **kw)

    monkeypatch.setattr(ops, "batch_fold", counting_bf)
    monkeypatch.setattr(ops, "pair_fuse_many", counting_pf)
    return calls


def _publish(q, pool, picks, n_ex, round_idx=0):
    for i, (j, n) in enumerate(zip(picks, n_ex)):
        q.publish_update(JOB, f"p{i}", pool[j], round_idx, int(n))


def _streaming(pool, picks, n_ex, st=None):
    st = st or FusionState()
    for j, n in zip(picks, n_ex):
        st = st.fold(pool[j], float(n))
    return st


def _same_state(a, b):
    assert a.total_weight == b.total_weight and a.n_fused == b.n_fused
    assert set(a.acc) == set(b.acc)
    for k in a.acc:
        assert a.acc[k].dtype == torch.float32
        assert torch.equal(a.acc[k], b.acc[k])


def test_drain_of_1000_is_the_streaming_fold_in_125_launches(counted):
    rng = np.random.default_rng(1000)
    pool = _pool(8)
    picks = rng.integers(0, 8, 1000)
    n_ex = rng.integers(100, 1001, 1000)
    q = MessageQueue()
    agg = AggregationExecutor(JOB, "fedavg", q)
    _publish(q, pool, picks, n_ex)
    l0, u0 = batch_fold.launches, batch_fold.updates
    assert agg.drain(0) == 1000
    assert (batch_fold.launches - l0, batch_fold.updates - u0) == (125, 1000)
    assert counted["pair_fuse_many"] == 0
    assert q.topic(f"updates/{JOB}").lag("aggregator") == 0
    _same_state(agg.state, _streaming(pool, picks, n_ex))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 13, 16])
def test_the_width_follows_the_backlog(counted, n):
    rng = np.random.default_rng(n)
    pool = _pool(3, seed=n)
    picks, n_ex = rng.integers(0, 3, n), rng.integers(100, 1001, n)
    q = MessageQueue()
    agg = AggregationExecutor(JOB, "fedavg", q)
    _publish(q, pool, picks, n_ex)
    l0, u0 = batch_fold.launches, batch_fold.updates
    assert agg.drain(0) == n
    assert batch_fold.launches - l0 == -(-n // FOLD_WIDTH)
    assert batch_fold.updates - u0 == n
    _same_state(agg.state, _streaming(pool, picks, n_ex))


def test_stale_messages_are_dropped_and_committed(counted):
    """Stale messages before, between and after a round's: the round's
    eleven fold as 8 + 3, every message committed."""
    pool = _pool(4, seed=2)
    q = MessageQueue()
    agg = AggregationExecutor(JOB, "fedavg", q)
    rounds = [0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0]
    kept = []
    for i, r in enumerate(rounds):
        q.publish_update(JOB, f"p{i}", pool[i % 4], r, 10 * (i + 1))
        if r == 1:
            kept.append((i % 4, 10 * (i + 1)))
    l0 = batch_fold.launches
    assert agg.drain(1) == 11
    assert batch_fold.launches - l0 == 2
    assert q.topic(f"updates/{JOB}").lag("aggregator") == 0
    picks, n_ex = zip(*kept)
    _same_state(agg.state, _streaming(pool, picks, n_ex))


def test_a_drain_of_part_of_the_backlog_commits_what_it_folded(counted):
    pool = _pool(2, seed=3)
    q = MessageQueue()
    agg = AggregationExecutor(JOB, "fedavg", q)
    _publish(q, pool, [0, 1] * 10, [100 + i for i in range(20)])
    assert agg.drain(0, max_messages=11) == 11
    assert q.topic(f"updates/{JOB}").lag("aggregator") == 9
    assert agg.drain(0) == 9
    assert q.topic(f"updates/{JOB}").lag("aggregator") == 0
    _same_state(agg.state, _streaming(pool, [0, 1] * 10,
                                      [100 + i for i in range(20)]))


def test_a_checkpoint_between_drains_keeps_its_partial(counted):
    """The second drain's first batch writes a new accumulator and its later
    ones update that one in place: the checkpointed partial stays the first
    drain's, and resuming from it redoes the rest exactly."""
    rng = np.random.default_rng(4)
    pool = _pool(5, seed=4)
    picks, n_ex = rng.integers(0, 5, 40), rng.integers(100, 1001, 40)
    q = MessageQueue()
    _publish(q, pool, picks, n_ex)
    agg = AggregationExecutor(JOB, "fedavg", q)
    assert agg.drain(0, max_messages=19) == 19
    agg.checkpoint()
    snap = q.latest_partial(JOB)
    frozen = {k: v.clone() for k, v in snap["acc"].items()}
    assert agg.drain(0) == 21  # three batches: new, in place, in place
    assert snap["n_fused"] == 19 and agg.state.n_fused == 40
    for k in frozen:
        assert torch.equal(snap["acc"][k], frozen[k])
    _same_state(agg.state, _streaming(pool, picks, n_ex))
    agg2 = AggregationExecutor(JOB, "fedavg", q, group="replay")
    assert agg2.resume()
    _same_state(_streaming(pool, picks[19:], n_ex[19:], agg2.state),
                agg.state)
