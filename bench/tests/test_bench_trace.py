"""The trace reduction: busy time, idle gaps named by the host operation
that covers their start, kernel times by name; on events that name their
activity and on events that do not (older PyTorch builds)."""
import pytest
import torch

from fedbench import devtrace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, dur, device, kind=None, tid=1):
        self._n, self._s, self._d, self._dev, self._tid = (name, start, dur,
                                                          device, tid)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return False


@pytest.mark.parametrize("named", [True, False])
def test_reduce(named):
    def ev(name, s, d, dev, kind):
        return Event(name, s, d, dev, kind if named else None)

    events = [
        ev("aten::add", 0, 100, CPU, "cpu_op"),
        ev("k1", 50, 100, CUDA, "kernel"),          # busy 50..150
        ev("k2", 120, 80, CUDA, "kernel"),          # busy ..200
        ev("aten::item", 210, 300, CPU, "cpu_op"),  # covers the gap's start
        ev("k1", 400, 100, CUDA, "kernel"),         # busy 400..500
    ]
    out = devtrace.reduce(events, 0, 600)
    assert out["busy_s"] == pytest.approx(250e-9)
    assert out["window_s"] == pytest.approx(600e-9)
    assert out["kernels"]["k1"] == [2, pytest.approx(200e-9)]
    # gaps 0..50 (under aten::add), 200..400 (between ops), 500..600
    assert out["gaps"]["aten::add"] == pytest.approx(50e-9)
    assert out["gaps"]["no host op"] == pytest.approx(200e-9)
    assert out["gaps"]["aten::item"] == pytest.approx(100e-9)
    assert devtrace.idle_share(out) == pytest.approx(350 / 600)
    b = devtrace.breakdown(out)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 3
