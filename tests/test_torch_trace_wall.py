"""The port's wall-clock spans on the queue and the aggregator, on the CPU:
the disabled path never touches the tracer and changes no result, a drain
is an ``agg.drain`` span over ``queue.poll`` and one ``agg.fold`` a batch
of messages, the spans share ``torch.profiler``'s clock, the allocator counter
and the CUDA-event pair are read where they should be, a sim-time tracer
is refused, and the spans export to Chrome's format."""
import json

import numpy as np
import pytest
import torch

import repro_torch.fl.aggregator as aggregator
import repro_torch.kernels.ops as ops
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.aggregator import AggregationExecutor
from repro_torch.kernels import build
from repro_torch.kernels.batch_fold import Operands, batch_fold, plan
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

torch.set_num_threads(1)

SHAPES = ((8, 4), (16,), (2, 3, 5))
JOB = "job"


def _tree(rng):
    return {f"w{j}": torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for j, s in enumerate(SHAPES)}


def _round(tracer, k=4, stale=1, seed=0):
    """Publish ``k`` updates of round 1 and ``stale`` of round 0, drain
    round 1 and finish it; (new model, folded, queue, executor)."""
    rng = np.random.default_rng(seed)
    q = MessageQueue(tracer=tracer)
    agg = AggregationExecutor(JOB, "fedavg", q, tracer=tracer)
    for i in range(stale):
        q.publish_update(JOB, f"s{i}", _tree(rng), 0, 7)
    for i in range(k):
        q.publish_update(JOB, f"p{i}", _tree(rng), 1, 10 * (i + 1))
    folded = agg.drain(1)
    model = agg.finish_round(_tree(rng), 1)
    return model, folded, q, agg


@pytest.fixture
def counted_launches(monkeypatch):
    """``batch_fold`` counting a launch an update dtype and chunk of its
    leaves (``plan``), as it does on the card (the CPU's plain path
    launches nothing)."""
    real = ops.batch_fold

    def counting(acc, updates, weights, **kw):
        launches = plan([Operands(u.dtype, u.numel(), 0, 0, ())
                         for u in updates[0]],
                        *build.DEFAULT_SHAPES["batch_fold"])
        batch_fold.launches += len(launches)
        batch_fold.updates += len(launches) * len(updates)
        return real(acc, updates, weights, **kw)

    monkeypatch.setattr(ops, "batch_fold", counting)


def test_null_tracer_is_never_called_and_changes_nothing(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - the test is that it never runs
        raise AssertionError("NullTracer method called on a guarded path")

    for name in ("open", "close", "span", "event"):
        monkeypatch.setattr(NullTracer, name, boom)
    off, n_off, q, agg = _round(NULL_TRACER)
    assert q.tracer is NULL_TRACER and agg.tracer is NULL_TRACER
    assert MessageQueue().tracer is NULL_TRACER
    assert AggregationExecutor(JOB).tracer is NULL_TRACER
    on, n_on, _, _ = _round(Tracer(clock="wall"))
    assert n_off == n_on == 4
    for k in off:
        assert off[k].dtype == on[k].dtype
        assert torch.equal(off[k], on[k])


def test_drain_is_poll_and_one_fold_a_message(counted_launches):
    tr = Tracer(clock="wall")
    _, folded, _, _ = _round(tr, k=4, stale=1)
    spans = tr.take_spans()
    by = {}
    for s in spans:
        by.setdefault(f"{s.cat}.{s.name}", []).append(s)
    assert sorted(by) == ["agg.drain", "agg.finish", "agg.fold",
                          "queue.poll", "queue.publish"]
    assert [s.round_idx for s in by["queue.publish"]] == [0, 1, 1, 1, 1]
    assert [s.args["offset"] for s in by["queue.publish"]] == [0, 1, 2, 3, 4]
    (drain,), (poll,), (finish,) = by["agg.drain"], by["queue.poll"], \
        by["agg.finish"]
    assert drain.args == {"folded": 4, "stale": 1} and folded == 4
    assert poll.parent == drain.seq and poll.args == {"messages": 5}
    folds = by["agg.fold"]
    assert len(folds) == 1  # the four messages of round 1 in one batch
    for s in [poll, *folds]:
        assert s.parent == drain.seq
        assert (s.job_id, s.round_idx) == (JOB, 1)
        assert drain.t0 <= s.t0 <= s.t1 <= drain.t1
    # the batch starts the accumulator in one launch of its three leaves
    assert [(s.args["launches"], s.args["updates"]) for s in folds] == [
        (1, 4)]
    for s in folds:
        # the first message's timestamp is a float of seconds (a ulp of
        # 238 ns)
        assert 0 <= s.args["wait_ns"] \
            <= s.t0 - by["queue.publish"][1].t0 + 1_000
    assert (finish.job_id, finish.round_idx, finish.parent) == (JOB, 1, None)
    # off the card: no CUDA events, no allocator reading
    assert finish.device_s is None and "device_allocs" not in finish.args
    assert "alloc.device_allocs" not in tr.metrics.counters
    assert tr.take_spans() == []


def test_fold_ops_start_inside_their_fold_span():
    """The shared clock: every operator the profiler sees inside the drain
    starts inside one of its ``agg.fold`` spans."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(clock="wall")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _round(tr, k=5, stale=0)
    spans = tr.take_spans()
    (drain,) = [s for s in spans if s.name == "drain"]
    folds = [s for s in spans if s.name == "fold"]
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if not e.is_user_annotation()
              and drain.t0 <= e.start_ns() <= drain.t1]
    inside = {s.seq: 0 for s in folds}
    for t in starts:
        (hit,) = [s.seq for s in folds if s.t0 <= t <= s.t1]
        inside[hit] += 1
    assert all(n > 0 for n in inside.values()), inside


def test_allocator_counter_and_device_events(monkeypatch):
    """On the card (stood in for here): the allocator is read at the open
    and close of ``agg.drain`` and ``agg.finish`` only, and ``agg.finish``
    carries the device time between its two CUDA events."""
    readings = iter([10, 12, 12, 15])

    class Event:
        at = 0.0

        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            Event.at += 2.5
            self.t = Event.at

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(aggregator, "_device_allocs", lambda: next(readings))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    tr = Tracer(clock="wall")
    _round(tr, k=3, stale=0)
    spans = {s.name: s for s in tr.take_spans()}
    assert spans["drain"].args["device_allocs"] == 2
    assert spans["finish"].args["device_allocs"] == 3
    assert tr.metrics.counter("alloc.device_allocs").n == 5
    assert spans["finish"].device_s == pytest.approx(2.5e-3)
    assert spans["drain"].device_s is None


@pytest.mark.parametrize("make", [
    lambda: MessageQueue(tracer=Tracer()),
    lambda: AggregationExecutor(JOB, tracer=Tracer()),
    lambda: Tracer().open("agg", "drain"),
    lambda: Tracer(clock="wall").span(0.0, 1.0, "container", "task"),
    lambda: Tracer(clock="wall").event(0.0, "cluster", "preempt"),
    lambda: Tracer(clock="tsc"),
], ids=["queue", "executor", "open_on_sim", "span_on_wall",
        "event_on_wall", "unknown_clock"])
def test_one_clock_a_tracer(make):
    with pytest.raises(ValueError):
        make()


def test_open_spans_stay_until_closed():
    tr = Tracer(clock="wall")
    outer = tr.open("agg", "drain", JOB, 3)
    inner = tr.open("agg", "fold", parent=outer)
    tr.close(inner, launches=0)
    (s,) = tr.take_spans()
    assert (s.seq, s.parent, s.job_id, s.round_idx) == (inner, outer, JOB, 3)
    assert tr.start_ns(outer) <= s.t0 <= s.t1
    tr.close(outer)
    assert [s.seq for s in tr.take_spans()] == [outer]


def test_export_chrome_wall_clock(tmp_path):
    tr = Tracer(clock="wall")
    _round(tr, k=2, stale=0)
    spans = tr.spans
    path = tmp_path / "wall.json"
    n = tr.export_chrome(str(path))
    tevs = json.loads(path.read_text())["traceEvents"]
    assert n == len(tevs)
    jobs = [e for e in tevs if e["ph"] == "M" and e["name"] == "thread_name"]
    assert [e["args"]["name"] for e in jobs] == [JOB]
    xs = [e for e in tevs if e["ph"] == "X"]
    assert len(xs) == len(spans)
    for e, s in zip(xs, spans):
        assert (e["pid"], e["tid"]) == (2, jobs[0]["tid"])
        assert (e["cat"], e["name"]) == (s.cat, s.name)
        assert e["ts"] == pytest.approx(s.t0 / 1e3)
        assert e["dur"] == pytest.approx((s.t1 - s.t0) / 1e3)
        assert (e["args"]["id"], e["args"]["parent"], e["args"]["round"]) \
            == (s.seq, s.parent, s.round_idx)
