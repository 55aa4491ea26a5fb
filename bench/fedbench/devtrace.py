"""The device trace of one stretch of a run: ``torch.profiler`` around it,
reduced to the seconds the card was busy, the device time of each kernel
by name, and the idle gaps named by the host operation that was running
when each began. On the card only the CUDA activity is traced (kernels,
copies, fills and the host's CUDA runtime calls): tracing every host
operator as well doubled a federated round's host time, and with it the
idle share it would read."""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime")
NAME_CHARS = 160


class DeviceTrace:
    """``with DeviceTrace(device) as tr: ...`` then ``tr.summary``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[Dict] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts = [ProfilerActivity.CUDA]
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce(
                self._prof.profiler.kineto_results.events(), self._t0, t1)
        self._prof = None
        return False


def _kind(e) -> str:
    """The event's activity kind; from its device and annotation flag
    where the PyTorch build's events do not name it."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    on_card = e.device_type() == torch.autograd.DeviceType.CUDA
    if annotation:
        return "gpu_user_annotation" if on_card else "user_annotation"
    return "kernel" if on_card else "cpu_op"


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(events, t0: int, t1: int) -> Dict:
    """busy_s, window_s, kernels {name: [launches, seconds]}, gaps
    {host op: seconds} of the events between wall-clock ns t0 and t1."""
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_KINDS or kind in HOST_KINDS:
            s = e.start_ns()
            span = (s, s + e.duration_ns(), e.name())
            if kind in DEVICE_KINDS:
                dev.append(span)
            else:
                host.append(span + (e.start_thread_id(),))
    kernels: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = _merge([(max(s, t0), min(e, t1)) for s, e, _ in dev
                   if e > t0 and s < t1])
    busy_ns = sum(e - s for s, e in busy)
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return {"busy_s": busy_ns * 1e-9, "window_s": (t1 - t0) * 1e-9,
            "kernels": dict(kernels), "gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Each gap's seconds under the innermost host operation of the main
    thread that covers its start ("no host op" between operations: on the
    card, host code outside any CUDA runtime call)."""
    if host:
        main = collections.Counter(h[3] for h in host).most_common(1)[0][0]
        host = sorted((s, e, n) for s, e, n, tid in host if tid == main)
    out: Dict[str, float] = collections.defaultdict(float)
    stack: List[Tuple[int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] <= g0:
            while stack and stack[-1][0] <= host[i][0]:
                stack.pop()
            stack.append((host[i][1], host[i][2]))
            i += 1
        while stack and stack[-1][0] <= g0:
            stack.pop()
        out[stack[-1][1] if stack else "no host op"] += (g1 - g0) * 1e-9
    return dict(out)


def breakdown(summary: Dict, top: int = 10) -> Dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, (_, s) in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def idle_share(summary: Optional[Dict]) -> Optional[float]:
    """1 - busy / window of a trace; None without a trace or device work."""
    if not summary or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 1.0 - summary["busy_s"] / summary["window_s"]
