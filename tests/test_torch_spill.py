"""The queue's spill of fused models off the card (``core/spill.py``), on
the CPU with a stand-in copier in place of the card's pinned copies: a
model published with ``publish_fused`` is held until the next
``poll_updates`` and then moved; every fused model polled from offset 0
equals what ``finish_round`` returned, at the same offsets and keys; the
host's reserve leaves a payload on the card while the card can spare it,
else sends it to disk, and the disk's reserve leaves it on the card, where a
failed copy leaves it too; publishing waits while the
payloads pending would pass the budget; the worker thread is joined when
the spill goes; a queue on the CPU starts no thread. The file route's
layout is held by writing the bytes as the card's copy would."""
import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch.core.queue as queue_mod
from repro_torch.core import spill
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.aggregator import AggregationExecutor

torch.set_num_threads(1)

SHAPES = ((8, 4), (16,), (2, 3, 5))
JOB = "job"


class Copier:
    """The card's copies stood in for: clones, recorded by route."""

    def __init__(self, fail=False, gate=None):
        self.fail, self.gate = fail, gate
        self.calls = []

    def to_memory(self, leaves, ready):
        self.calls.append("memory")
        if self.gate is not None:
            assert self.gate.wait(10)
        if self.fail:
            raise OSError("no room")
        return [t.clone() for t in leaves]

    def to_file(self, leaves, ready, directory):
        self.calls.append("file")
        return [t.clone() for t in leaves]


@pytest.fixture
def cpu_spill(monkeypatch):
    """The queue's spill taking payloads on the CPU as it takes them on the
    card, with a ``Copier`` (``made["copier"]``), a budget of
    ``made["budget"]`` bytes and ``made["spare"]`` bytes that the card can
    spare (none by default)."""
    made = {"copier": Copier(), "budget": 1 << 40, "spare": -1}

    class CPUSpill(spill.HostSpill):
        def takes(self, value):
            return bool(spill.tree_leaves(value))

        def ready(self, value):
            return None

        def budget(self, value):
            return made["budget"]

        def spare(self):
            return lambda value: made["spare"]

        def copier(self):
            return made["copier"]

    monkeypatch.setattr(queue_mod, "HostSpill", CPUSpill)
    return made


def _tree(rng):
    return {f"w{j}": torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for j, s in enumerate(SHAPES)}


def _rounds(q, n, seed=0):
    """``n`` rounds of 3 updates drained and finished; the models
    ``finish_round`` returned."""
    rng = np.random.default_rng(seed)
    agg = AggregationExecutor(JOB, "fedavg", q)
    model, out = _tree(rng), []
    for r in range(n):
        for i in range(3):
            q.publish_update(JOB, f"p{i}", _tree(rng), r, 10 * (i + 1))
        assert agg.drain(r) == 3
        model = agg.finish_round(model, r)
        out.append(model)
    return out


def test_every_fused_model_polled_from_offset_0_is_finish_rounds(cpu_spill):
    copier = cpu_spill["copier"]
    q = MessageQueue()
    returned = _rounds(q, 5)
    q.spill.wait()
    late = q.topic(f"fused/{JOB}").poll("late")
    assert [(m.offset, m.key) for m in late] == [(r, str(r)) for r in
                                                 range(5)]
    # released at the next round's poll: the newest is still the card's own
    assert copier.calls == ["memory"] * 4
    assert late[-1].value is returned[-1]
    for m, want in zip(late, returned):
        assert set(m.value) == set(want)
        for k in want:
            assert m.value[k].dtype == want[k].dtype
            assert torch.equal(m.value[k], want[k])
    assert all(m.value is not want for m, want in zip(late[:-1], returned))
    q.poll_updates(JOB, "aggregator")  # releases the newest
    q.spill.wait()
    assert copier.calls == ["memory"] * 5
    assert q.spill.stats.to_memory == 5
    assert q.spill.stats.spilled_bytes == 5 * sum(
        2 * int(np.prod(s)) for s in SHAPES)


@pytest.mark.parametrize("available, spare, disk_reserve, route", [
    (None, 0, 0, "memory"),  # unknown: host memory
    (1 << 40, 0, 0, "memory"),
    (1 << 10, 0, 0, None),  # under the reserve: the card keeps it if it can
    (1 << 10, -1, 0, "file"),  # else disk
    (1 << 10, -1, 1 << 62, None),  # neither: the card keeps it
], ids=["unknown", "memory", "card-first", "disk", "card"])
def test_the_reserves_choose_the_route(cpu_spill, monkeypatch, available,
                                       spare, disk_reserve, route):
    monkeypatch.setattr(spill, "mem_available", lambda: available)
    monkeypatch.setattr(spill, "RESERVE_BYTES", 1 << 20)
    monkeypatch.setattr(spill, "DISK_RESERVE_BYTES", disk_reserve)
    cpu_spill["spare"] = spare
    copier = cpu_spill["copier"]
    q = MessageQueue()
    model = _tree(np.random.default_rng(1))
    q.publish_fused(JOB, 0, model)
    q.poll_updates(JOB, "g")
    q.spill.wait()
    (m,) = q.topic(f"fused/{JOB}").poll("late")
    st = q.spill.stats
    assert copier.calls == ([route] if route else [])
    assert (m.value is model) == (route is None)
    assert (st.to_memory, st.to_disk, st.kept) == (
        int(route == "memory"), int(route == "file"), int(route is None))


def test_a_failed_copy_keeps_the_payload_and_is_raised(cpu_spill):
    cpu_spill["copier"] = Copier(fail=True)
    q = MessageQueue()
    model = _tree(np.random.default_rng(2))
    q.publish_fused(JOB, 0, model)
    q.poll_updates(JOB, "g")
    q.spill.wait()
    assert q.topic(f"fused/{JOB}").poll("late")[0].value is model
    with pytest.raises(RuntimeError, match="off the card"):
        q.poll_updates(JOB, "g")


def test_publishing_waits_beyond_the_budget(cpu_spill):
    """With the worker still copying model 0 and a budget of one model,
    publishing model 1 waits for it: the card never holds more than the
    two."""
    go = threading.Event()
    cpu_spill["copier"] = Copier(gate=go)
    cpu_spill["budget"] = sum(2 * int(np.prod(x)) for x in SHAPES)
    rng = np.random.default_rng(6)
    q = MessageQueue()
    q.publish_fused(JOB, 0, _tree(rng))
    q.poll_updates(JOB, "g")  # model 0 to the worker, which waits on go
    done = threading.Event()
    t = threading.Thread(target=lambda: (q.publish_fused(JOB, 1, _tree(rng)),
                                         done.set()))
    t.start()
    assert not done.wait(0.3)
    go.set()
    assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    st = q.spill.stats
    assert st.to_memory == 1 and st.waited_s > 0


@pytest.mark.parametrize("spare, waits", [(-1, True), (1 << 40, False)],
                         ids=["no-room", "room"])
def test_the_budget_is_the_payloads_waiting_and_the_cards_spare(
        cpu_spill, monkeypatch, spare, waits):
    """``budget`` itself: with the worker still copying model 0, publishing
    model 1 waits for it where the card can spare nothing, and not where it
    can spare more than both."""
    monkeypatch.setattr(queue_mod.HostSpill, "budget", spill.HostSpill.budget)
    go = threading.Event()
    cpu_spill["copier"] = Copier(gate=go)
    cpu_spill["spare"] = spare
    rng = np.random.default_rng(7)
    q = MessageQueue()
    q.publish_fused(JOB, 0, _tree(rng))
    q.poll_updates(JOB, "g")  # model 0 to the worker, which waits on go
    done = threading.Event()
    t = threading.Thread(target=lambda: (q.publish_fused(JOB, 1, _tree(rng)),
                                         done.set()))
    t.start()
    assert done.wait(0.3) is not waits
    go.set()
    assert done.wait(10)
    t.join(10)
    q.poll_updates(JOB, "g")
    q.spill.wait()
    assert q.spill.stats.to_memory == 2 and q.spill._pending.bytes == 0


def test_the_first_hold_gives_the_card_its_standby(cpu_spill, monkeypatch):
    """``standby`` runs once, at the first ``hold``, with the payload's
    bytes; on the CPU it takes nothing."""
    calls = []
    monkeypatch.setattr(queue_mod.HostSpill, "standby",
                        lambda self, value, need: calls.append(need))
    q = MessageQueue()
    _rounds(q, 3)
    assert calls == [sum(2 * int(np.prod(s)) for s in SHAPES)]
    tree = _tree(np.random.default_rng(8))
    assert spill.HostSpill().standby(tree, 1) is None  # CPU leaves: a no-op


def test_many_publishers_keep_the_budget(cpu_spill, monkeypatch):
    """Stress: eight threads publish 40 models each against a budget of
    three, with the interpreter switching threads every microsecond; every
    model moves and, at the end, nothing is pending."""
    one = sum(2 * int(np.prod(x)) for x in SHAPES)
    cpu_spill["budget"] = 3 * one
    q = MessageQueue()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def publish(k):
            rng = np.random.default_rng(k)
            for r in range(40):
                q.publish_fused(f"{JOB}{k}", r, _tree(rng))
                q.poll_updates(JOB, "g")
                assert q.spill._pending.bytes <= 3 * one

        threads = [threading.Thread(target=publish, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    q.poll_updates(JOB, "g")
    q.spill.wait()
    assert q.spill.stats.to_memory == 8 * 40
    assert q.spill._pending.bytes == 0


def test_the_worker_is_joined_when_the_spill_goes(cpu_spill):
    def workers():
        return {t for t in threading.enumerate() if t.name == "host-spill"}

    before = workers()
    q = MessageQueue()
    q.publish_fused(JOB, 0, _tree(np.random.default_rng(3)))
    q.poll_updates(JOB, "g")
    (worker,) = workers() - before
    del q
    gc.collect()
    worker.join(10)
    assert not worker.is_alive()


def test_a_queue_on_the_cpu_moves_nothing():
    q = MessageQueue()
    assert not q.spill.takes(_tree(np.random.default_rng(4)))
    returned = _rounds(q, 2)
    assert q.spill._work is None
    late = q.topic(f"fused/{JOB}").poll("late")
    assert [m.value for m in late] == returned


def test_the_file_route_maps_what_was_written(tmp_path, monkeypatch):
    """``StagedCopy.to_file`` with the card's copy stood in for by writes of
    the same bytes at the offsets it is given: the leaves come back in
    their shapes and dtypes, each aligned, and the file is unlinked."""
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((3, 5), (7,), (0,), (2, 2))]
    leaves[1] = leaves[1].to(torch.bfloat16)

    def write(self, srcs, ready, dst, fd):
        for t, off in zip(srcs, dst):
            assert off % spill.ALIGN == 0
            if t.numel():
                os.pwrite(fd, t.contiguous().view(-1).view(torch.uint8)
                          .numpy().tobytes(), off)

    monkeypatch.setattr(spill.StagedCopy, "_copy", write)
    got = spill.StagedCopy().to_file(leaves, None, str(tmp_path))
    assert os.listdir(tmp_path) == []
    for g, want in zip(got, leaves, strict=True):
        assert g.dtype == want.dtype and g.shape == want.shape
        assert torch.equal(g, want)
