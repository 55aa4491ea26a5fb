"""The readings of the program's spans (``fedbench/spans.py``) on
hand-made records, and None where a program records none; the device
trace's gap intervals and launch calls on hand-made events; and a run of
``spans_run.py`` on the CPU at a small size, spans on and off."""
import collections

import pytest
import torch

import spans_run
from fedbench import spans

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

S = collections.namedtuple("S", "seq t0 t1 cat name args parent device_s")


def _s(seq, t0, t1, what, parent=None, device_s=None, **args):
    cat, name = what.split(".")
    return S(seq, t0, t1, cat, name, args, parent, device_s)


# two rounds (ns): publishes, a drain over a poll and folds, a finish
ROUND_A = [
    _s(1, 0, 10, "queue.publish", offset=0),
    _s(2, 20, 30, "queue.publish", offset=1),
    _s(4, 110, 150, "queue.poll", parent=3, messages=3),
    _s(5, 200, 300, "agg.fold", parent=3, launches=0, wait_ns=190),
    _s(6, 400, 600, "agg.fold", parent=3, launches=17, wait_ns=380),
    _s(7, 700, 800, "agg.fold", parent=3, launches=17, wait_ns=680),
    _s(3, 100, 1000, "agg.drain", folded=3, stale=0, device_allocs=1),
    _s(8, 1100, 1300, "agg.finish", device_s=0.002, device_allocs=14),
]
ROUND_B = [
    _s(9, 2000, 2040, "queue.publish", offset=2),
    _s(11, 2110, 2120, "queue.poll", parent=10, messages=1),
    _s(12, 2200, 2300, "agg.fold", parent=10, launches=17, wait_ns=160),
    _s(10, 2100, 2500, "agg.drain", folded=1, stale=0, device_allocs=0),
    _s(13, 2600, 2700, "agg.finish", device_s=0.004, device_allocs=14),
]
ROUNDS = [ROUND_A, ROUND_B]
# idle gaps of round A: in a fold (10 + 20 ns), between two publishes
# (the publish loop), in the poll, in the drain between its children,
# before any span and after the drain
GAPS = [(250, 260), (450, 470), (12, 15), (120, 130), (160, 170),
        (1000, 1100), (-50, -40)]

CASES = {
    # 400 ns over 51 launches; the first fold launched none
    "fold_host_us": (lambda r: spans.fold_host_us(r), 400 / 51 / 1e3),
    # each round's first launching fold: 200 + 100 ns over 34 launches
    "fold_host_us_first": (lambda r: spans.fold_host_us(r, first=1),
                           300 / 34 / 1e3),
    # A: 20 ns of publish + 900 - 400 of drain; B: 40 + 400 - 100
    "queue_ms": (lambda r: spans.queue_ms(r),
                 ((20 + 900 - 400) + (40 + 400 - 100)) / 2 / 1e6),
    "finish_ms": (lambda r: spans.finish_ms(r), 3.0),
    # host ms of agg.finish: 200 and 100 ns
    "finish_host_ms": (lambda r: spans.span_ms(r, spans.FINISH), 150 / 1e6),
    "device_allocs": (lambda r: spans.device_allocs(r),
                      {"total": 14.5, "drain": 0.5, "finish": 14.0}),
    "idle_in_fold_ms": (lambda r: spans.idle_in_fold_ms(
        GAPS if r else None, r[0] if r else []), 30 / 1e6),
}


@pytest.mark.parametrize("reading", sorted(CASES))
def test_reading(reading):
    fn, expect = CASES[reading]
    got = fn(ROUNDS)
    if isinstance(expect, dict):
        assert got == pytest.approx(expect)
    else:
        assert got == pytest.approx(expect, rel=1e-12)
    # a program that records no spans: nothing to read
    assert fn([]) is None and fn([[], []]) is None


def test_idle_by_span_takes_the_innermost_span():
    got = spans.idle_by_span(GAPS, spans.intervals(ROUND_A))
    assert got == pytest.approx({
        "agg.fold": 30e-9, spans.PUBLISH_LOOP: 3e-9, "queue.poll": 10e-9,
        "agg.drain": 10e-9, spans.OUTSIDE: 110e-9})
    assert spans.idle_in_fold_ms(GAPS, []) is None


def test_split_shares_a_gap_among_the_spans_it_crosses():
    iv = spans.intervals(ROUND_A)
    gap = [(5, 25)]  # from a publish, across the loop, into the next
    assert spans.idle_by_span(gap, iv) == pytest.approx(
        {"queue.publish": 20e-9})
    assert spans.idle_by_span(gap, iv, split=True) == pytest.approx(
        {"queue.publish": 10e-9, spans.PUBLISH_LOOP: 10e-9})
    assert spans.cut([(90, 210)], iv) == [(90, 100), (100, 110),
                                          (110, 150), (150, 200),
                                          (200, 210)]


def test_queue_parts():
    assert spans.queue_parts_ms(ROUNDS) == pytest.approx(
        [(20e-6, 500e-6), (40e-6, 300e-6)])
    assert spans.queue_parts_ms([[], ROUND_A[:2]]) == []


def test_inside_counts_starts_within_spans():
    starts = [0, 199, 200, 250, 300, 301, 650, 700, 2250]
    assert spans.inside(starts, ROUND_A + ROUND_B, spans.FOLD) == 5


class Event:
    def __init__(self, name, start, dur, device, corr=0):
        self._n, self._s, self._d, self._dev, self._c = (name, start, dur,
                                                          device, corr)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return False


def test_gap_intervals_and_launch_calls():
    events = [
        Event("cudaLaunchKernel", 0, 10, CPU, 1),
        Event("pair_fuse_kernel<1, float>", 50, 100, CUDA, 1),   # 50..150
        Event("cudaLaunchKernel", 60, 10, CPU, 2),
        Event("vectorized_elementwise_kernel", 120, 80, CUDA, 2),  # ..200
        Event("cudaMalloc", 210, 300, CPU, 3),
        Event("cudaLaunchKernel", 510, 10, CPU, 4),
        Event("pair_fuse_kernel<1, float>", 520, 30, CUDA, 4),   # 520..550
    ]
    assert spans.gap_intervals(events, 0, 600) == [(0, 50), (200, 520),
                                                   (550, 600)]
    assert spans.gap_intervals(events, 100, 530) == [(200, 520)]
    assert spans.launch_starts(events, "pair_fuse") == [0, 510]


@pytest.mark.parametrize("with_spans", [True, False])
def test_spans_run_on_the_cpu(tiny, with_spans):
    cell = "agg_backlog.mamba2-130m"
    config, traffic = tiny(cell)
    out = spans_run.run_cell(cell, 2**31 + 7, 0.0, with_spans,
                             torch.device("cpu"), config, traffic)
    assert out["rounds"] == 1 and out["fold_ms"] > 0
    # the CPU launches no pair_fuse, times no CUDA event, reads no
    # allocator and runs no device trace
    for key in ("fold_host_us", "fold_host_us_first", "finish_ms",
                "device_allocs", "idle_in_fold_ms"):
        assert out[key] is None
    assert (out["queue_ms"] is not None) == with_spans
