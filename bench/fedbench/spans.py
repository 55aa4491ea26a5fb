"""The program's own spans in the aggregator cells, read beside the device
trace of the same round.

The program records them when its queue and executor are given a
wall-clock tracer (``repro_torch.obs.trace.Tracer(clock="wall")``):
``queue.publish`` a published update, and a round's ``agg.drain`` over
one ``queue.poll`` and one ``agg.fold`` a message folded (its
``pair_fuse`` launches, ``launches``), then ``agg.finish`` (its device
time between two CUDA events, ``device_s``); drain and finish carry the
allocator's ``cudaMalloc`` calls (``device_allocs``) on the card. A span
record has ``seq`` (its id), ``t0`` / ``t1`` (ns of ``time.time_ns()``,
the clock of ``torch.profiler``'s events), ``cat``, ``name``, ``args``,
``parent`` and ``device_s``.

Each reading takes the spans of the window's rounds, one list a round,
and is None when there are none (a program that records no spans). The
device side (``RoundTrace``) keeps what ``devtrace.reduce`` drops: the
idle gaps' intervals and the host start of each ``pair_fuse`` launch."""
from __future__ import annotations

import bisect
import collections
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fedbench import devtrace

PUBLISH, POLL, DRAIN, FOLD, FINISH = ("queue.publish", "queue.poll",
                                      "agg.drain", "agg.fold", "agg.finish")
#: the harness's loop of ``publish_update`` calls, first publish to last
PUBLISH_LOOP = "publish loop"
OUTSIDE = "outside spans"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")

Interval = Tuple[int, int, str]


def name(s) -> str:
    return f"{s.cat}.{s.name}"


def _of(spans, what: str) -> list:
    return [s for s in spans if name(s) == what]


def fold_host_us(rounds: Sequence[Sequence],
                 first: Optional[int] = None) -> Optional[float]:
    """Host us a ``pair_fuse`` launch: the ``agg.fold`` spans that
    launched (a round's first fold makes the accumulator and launches
    none), their ns over their launches; with ``first``, only each
    round's first ``first`` such folds. Once the card's launch queue is
    full a launch waits for a slot, so a fold's span then lasts as long as
    its device time; a round opens on an empty queue (the round before
    ended in a synchronise), so its first folds show the host's own
    cost."""
    ns = launches = 0
    for spans in rounds:
        folds = [s for s in _of(spans, FOLD) if s.args["launches"]]
        for s in folds[:first]:
            ns += s.t1 - s.t0
            launches += s.args["launches"]
    return ns / launches / 1e3 if launches else None


def queue_parts_ms(rounds: Sequence[Sequence]) -> List[Tuple[float, float]]:
    """(publish, drain) ms of each round that drained: its
    ``queue.publish`` spans, and its ``agg.drain`` outside its
    ``agg.fold`` children (the poll, stale checks, commits)."""
    per = []
    for spans in rounds:
        drains = _of(spans, DRAIN)
        if not drains:
            continue
        drain = sum(d.t1 - d.t0 - sum(s.t1 - s.t0 for s in _of(spans, FOLD)
                                      if s.parent == d.seq) for d in drains)
        per.append((sum(s.t1 - s.t0 for s in _of(spans, PUBLISH)) / 1e6,
                    drain / 1e6))
    return per


def queue_ms(rounds: Sequence[Sequence]) -> Optional[float]:
    """ms a round in the queue (``queue_parts_ms`` summed), the median
    over rounds."""
    per = [p + d for p, d in queue_parts_ms(rounds)]
    return statistics.median(per) if per else None


def span_ms(rounds: Sequence[Sequence], what: str) -> Optional[float]:
    """Host ms of the ``what`` spans a round, the median over rounds."""
    per = [sum(s.t1 - s.t0 for s in _of(spans, what)) / 1e6
           for spans in rounds if _of(spans, what)]
    return statistics.median(per) if per else None


def finish_ms(rounds: Sequence[Sequence]) -> Optional[float]:
    """Device ms between ``agg.finish``'s CUDA events (the result's divide
    and cast, ``apply``, ``publish_fused``), the median over rounds."""
    per = [s.device_s * 1e3 for spans in rounds for s in _of(spans, FINISH)
           if s.device_s is not None]
    return statistics.median(per) if per else None


def device_allocs(rounds: Sequence[Sequence]) -> Optional[Dict[str, float]]:
    """``cudaMalloc`` calls a round in ``agg.drain`` and ``agg.finish``,
    the mean over rounds: {"total", "drain", "finish"}."""
    parts = {DRAIN: [], FINISH: []}
    for spans in rounds:
        for what, got in parts.items():
            got.extend(s.args["device_allocs"] for s in _of(spans, what)
                       if "device_allocs" in s.args)
    if not parts[DRAIN] or not parts[FINISH]:
        return None
    n = len(rounds)
    drain, finish = sum(parts[DRAIN]) / n, sum(parts[FINISH]) / n
    return {"total": drain + finish, "drain": drain, "finish": finish}


def intervals(spans: Sequence) -> List[Interval]:
    """A round's spans as (t0, t1, name), and the publish loop around its
    ``queue.publish`` spans."""
    out = [(s.t0, s.t1, name(s)) for s in spans]
    pub = _of(spans, PUBLISH)
    if pub:
        out.append((min(s.t0 for s in pub), max(s.t1 for s in pub),
                    PUBLISH_LOOP))
    return out


def innermost(gaps: Sequence[Tuple[int, int]],
              spans: Sequence[Interval]) -> List[Interval]:
    """Each gap with the name of the innermost span that covers its start
    (``OUTSIDE`` where none does). Spans nest or are disjoint."""
    out = []
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack: List[Tuple[int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(order) and order[i][0] <= g0:
            while stack and stack[-1][0] <= order[i][0]:
                stack.pop()
            stack.append((order[i][1], order[i][2]))
            i += 1
        while stack and stack[-1][0] <= g0:
            stack.pop()
        out.append((g0, g1, stack[-1][1] if stack else OUTSIDE))
    return out


def cut(gaps: Sequence[Tuple[int, int]],
        spans: Sequence[Interval]) -> List[Tuple[int, int]]:
    """The gaps cut at every span's start and end, so that one span is
    innermost over the whole of each piece."""
    bounds = sorted({t for s in spans for t in s[:2]})
    out = []
    for g0, g1 in gaps:
        at = [g0, *bounds[bisect.bisect_right(bounds, g0):
                          bisect.bisect_left(bounds, g1)], g1]
        out.extend(zip(at, at[1:]))
    return out


def idle_by_span(gaps: Sequence[Tuple[int, int]], spans: Sequence[Interval],
                 split: bool = False) -> Dict[str, float]:
    """Idle seconds by the innermost span covering each gap's start, or,
    with ``split``, covering each idle nanosecond (a gap that runs on
    across spans is shared among them)."""
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1, name_ in innermost(cut(gaps, spans) if split else gaps,
                                   spans):
        out[name_] += (g1 - g0) * 1e-9
    return dict(out)


def idle_in_fold_ms(gaps: Optional[Sequence[Tuple[int, int]]],
                    spans: Sequence) -> Optional[float]:
    """Idle ms of a traced round whose gap starts inside an ``agg.fold``
    span: the host's launch path holding the card."""
    if gaps is None or not _of(spans, FOLD):
        return None
    return 1e3 * idle_by_span(gaps, intervals(spans)).get(FOLD, 0.0)


def inside(starts: Sequence[int], spans: Sequence, what: str) -> int:
    """How many of ``starts`` (ns) lie inside a ``what`` span."""
    iv = sorted((s.t0, s.t1) for s in _of(spans, what))
    t0s = [a for a, _ in iv]
    n = 0
    for t in starts:
        j = bisect.bisect_right(t0s, t) - 1
        n += j >= 0 and t <= iv[j][1]
    return n


def gap_intervals(events, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The (start, end) ns of the stretches between t0 and t1 in which no
    kernel, copy or fill ran on the card (``devtrace.reduce``'s gaps)."""
    dev = []
    for e in events:
        if devtrace._kind(e) in devtrace.DEVICE_KINDS:
            s = e.start_ns()
            end = s + e.duration_ns()
            if end > t0 and s < t1:
                dev.append((max(s, t0), min(end, t1)))
    gaps, at = [], t0
    busy = devtrace._merge(dev)
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def launch_starts(events, kernel: str) -> List[int]:
    """Host start (ns) of each runtime launch call whose kernel's name
    holds ``kernel``, matched by the profiler's correlation id."""
    corr = {e.correlation_id() for e in events
            if devtrace._kind(e) == "kernel" and kernel in e.name()}
    return [e.start_ns() for e in events
            if e.name() in LAUNCH_CALLS and e.correlation_id() in corr]


class RoundTrace(devtrace.DeviceTrace):
    """``devtrace.DeviceTrace`` that also keeps the gaps' intervals
    (``gaps``), ``pair_fuse``'s launch calls' starts (``launches``) and
    the host events as ``devtrace.reduce`` takes them (``host``)."""

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            events = self._prof.profiler.kineto_results.events()
            self.summary = devtrace.reduce(events, self._t0, t1)
            self.gaps = gap_intervals(events, self._t0, t1)
            self.launches = launch_starts(events, "pair_fuse")
            self.host = [(e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name(), e.start_thread_id()) for e in events
                         if devtrace._kind(e) in devtrace.HOST_KINDS]
        self._prof = None
        return False
