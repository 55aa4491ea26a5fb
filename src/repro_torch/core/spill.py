"""Moving the queue's payloads off the card.

The queue's topics are append-only logs that never drop a payload: a
consumer group that polls late, from offset 0, still reads every fused
model. A fused model made on the card would stay there for the life of the
job, one model a round. ``HostSpill`` moves such payloads to the host:
``hold`` takes a message whose payload lies on the card, with an event on
the stream that made it; ``release`` hands what it holds to a worker
thread, which copies each payload off the card and then swaps the
message's value for the copy. Until the swap a poll reads the card's
tensors, after it the host's: the same model either way. The queue holds
the card's tensors until their copy is complete, so no stream can reuse
their memory before.

A payload goes to new pageable host memory while the host keeps
``RESERVE_BYTES`` available beside it; else it stays on the card while the
card keeps ``DEVICE_RESERVE_SHARE`` of its memory free; else it goes to a
file of its own in a directory under the temporary directory while that
disk keeps ``DISK_RESERVE_BYTES`` free beside it (its tensors then map the
file, which is unlinked at once, so the disk space returns with them); else
it stays on the card: a payload is never dropped. The copy (``kernels/csrc/
spill_copy.cu``) runs through two small pinned buffers in turn, outside the
interpreter's lock. Payloads may wait on the card for the worker while
the card keeps ``DEVICE_RESERVE_SHARE`` of its memory free beside them;
beyond that ``hold`` waits, so that the card never fills where the host
moves payloads slower than they come. The first ``hold`` gives the card's
allocator room for ``STANDBY_PAYLOADS`` payloads, so that those which wait
or stay on the card take no ``cudaMalloc`` while rounds run. The worker is
stopped and joined when the spill is collected or the interpreter exits,
never left running into the interpreter's teardown.
"""
from __future__ import annotations

import array
import os
import queue
import shutil
import tempfile
import threading
import time
import weakref
from typing import List, Optional

import torch

from repro_torch import tree_leaves, tree_unflatten

#: host memory kept available; a payload that would leave less stays on the
#: card or goes to disk. Writing files once the host's memory was short
#: slowed the rounds beside it by 3-9 % (PERF.md section 6)
RESERVE_BYTES = 8 << 30
#: disk space kept free; a payload that would leave less stays on the card
DISK_RESERVE_BYTES = 8 << 30
#: bytes of each of the two pinned staging buffers
CHUNK_BYTES = 64 << 20
#: threads that copy or write a piece out of a pinned buffer. The host, not
#: the copy, bounds it: 2.2-3.5 GB/s at 2, 4 or 8 threads on the 8-core host
#: of an NVIDIA H100 80GB HBM3 (PERF.md section 6)
COPY_THREADS = 4
#: alignment of each leaf in a payload's file, so that every dtype can view it
ALIGN = 64
#: share of the card's memory kept free beside the payloads held, being
#: moved or left on it: ``hold`` waits for the worker once the card has
#: less, and a payload the host has no memory for stays on the card only
#: while it has more. A fixed budget of a quarter of the card made rounds
#: wait on the host's copy rate, which differs from run to run (1.7-2.8
#: GB/s), where the card had room to let the worker catch up (PERF.md
#: section 6)
DEVICE_RESERVE_SHARE = 0.125
#: payloads whose bytes the card's allocator is given at the first ``hold``
#: (as far as the card can spare them), for the payloads that wait or stay
#: on the card. Got while rounds run instead, each 2.53-GB model's
#: ``cudaMalloc`` held the round 0.1-0.6 s (PERF.md section 6)
STANDBY_PAYLOADS = 16


def mem_available() -> Optional[int]:
    """The host's available memory in bytes (``MemAvailable`` of
    ``/proc/meminfo``), or None where it cannot be read."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def disk_free(path: str) -> int:
    """Bytes free to an unprivileged writer on ``path``'s file system."""
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def card_spare(value) -> int:
    """Bytes that the card of ``value``'s leaves has beyond what tensors
    take and ``DEVICE_RESERVE_SHARE`` of its memory; below 0 where it has
    less. Read from the allocator's counters, not the driver, whose
    ``cudaMemGetInfo`` at times held a round up to 0.8 s."""
    dev = tree_leaves(value)[0].device
    total = torch.cuda.get_device_properties(dev).total_memory
    return (int((1 - DEVICE_RESERVE_SHARE) * total)
            - torch.cuda.memory_allocated(dev))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _payload_bytes(value) -> int:
    return sum(_nbytes(t) for t in tree_leaves(value))


class StagedCopy:
    """Copies a payload's leaves from the card to new pageable host memory
    (``to_memory``) or to a file (``to_file``), which the returned leaves
    view, through two pinned buffers of ``CHUNK_BYTES``, on a side stream
    that first waits for ``ready``."""

    def __init__(self):
        self.stage: List[torch.Tensor] = []
        self.stream: Optional[torch.cuda.Stream] = None

    def _copy(self, leaves, ready, dst: List[int], fd: int) -> None:
        from repro_torch.kernels import build

        if self.stream is None:
            self.stream = torch.cuda.Stream(leaves[0].device)
            self.stage = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            src = [t.contiguous() for t in leaves]
        fn = build.library("spill_copy").spill_copy
        rows = [array.array("q", x) for x in (
            [t.data_ptr() for t in src], dst, [_nbytes(t) for t in src])]
        err = fn(*(r.buffer_info()[0] for r in rows), len(src),
                 self.stage[0].data_ptr(), self.stage[1].data_ptr(),
                 CHUNK_BYTES, fd, COPY_THREADS, self.stream.cuda_stream)
        if err:
            raise RuntimeError(f"spill_copy failed: {err}")

    def to_memory(self, leaves: List[torch.Tensor],
                  ready) -> List[torch.Tensor]:
        offsets, total = _layout(leaves)
        # plain pages, each made at its first touch by the copy: making them
        # all at once (MAP_POPULATE) took the host's memory lock long enough
        # to stall the rounds beside it (PERF.md section 6)
        flat = torch.empty(total, dtype=torch.uint8)
        self._copy(leaves, ready, [flat.data_ptr() + o for o in offsets], -1)
        return _views(flat, offsets, leaves)

    def to_file(self, leaves: List[torch.Tensor], ready,
                directory: str) -> List[torch.Tensor]:
        offsets, total = _layout(leaves)
        fd, path = tempfile.mkstemp(dir=directory, suffix=".payload")
        try:
            os.ftruncate(fd, total)
            self._copy(leaves, ready, offsets, fd)
        finally:
            os.close(fd)
        try:
            flat = torch.from_file(path, shared=False, size=total,
                                   dtype=torch.uint8)
        finally:
            os.unlink(path)
        return _views(flat, offsets, leaves)


def _layout(leaves: List[torch.Tensor]):
    """Each leaf's offset in one buffer, aligned to ``ALIGN``, and the
    buffer's bytes (at least 1)."""
    offsets, total = [], 0
    for t in leaves:
        offsets.append(total)
        total += -(-_nbytes(t) // ALIGN) * ALIGN
    return offsets, max(total, 1)


def _views(flat: torch.Tensor, offsets: List[int],
           leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """The leaves' shapes and dtypes as views of the bytes ``flat``."""
    return [flat[o:o + _nbytes(t)].view(t.dtype).view(t.shape)
            for o, t in zip(offsets, leaves)]


class Stats:
    """What a spill did: payloads moved to host memory and to disk, and
    their bytes; payloads left on the card; seconds ``hold`` waited for the
    worker."""

    def __init__(self):
        self.to_memory = 0
        self.to_disk = 0
        self.spilled_bytes = 0
        self.kept = 0
        self.waited_s = 0.0
        self.error: Optional[BaseException] = None


class _Pending:
    """Bytes of payloads held or handed to the worker and not yet done,
    shared by the spill and its worker."""

    def __init__(self):
        self.changed = threading.Condition()
        self.bytes = 0

    def take(self, n: int, budget: int) -> None:
        """Add ``n`` bytes once they fit the budget, or once nothing is
        pending."""
        with self.changed:
            while self.bytes and self.bytes + n > budget:
                self.changed.wait()
            self.bytes += n

    def done(self, n: int) -> None:
        with self.changed:
            self.bytes -= n
            self.changed.notify_all()


class _Worker:
    """What the worker thread needs, and nothing of the spill itself."""

    def __init__(self, copier, spare, stats: Stats, pending: _Pending):
        self.copier, self.spare = copier, spare
        self.stats, self.pending = stats, pending
        self.directory: Optional[str] = None

    def spill(self, msg, ready, need: int) -> None:
        """Move ``msg``'s payload of ``need`` bytes to host memory, or leave
        it on the card, or move it to disk, or leave it (module
        docstring)."""
        leaves = tree_leaves(msg.value)
        avail = mem_available()
        if avail is None or avail - need >= RESERVE_BYTES:
            host = self.copier.to_memory(leaves, ready)
            self.stats.to_memory += 1
        else:
            if self.spare(msg.value) >= 0:
                self.stats.kept += 1
                return
            if self.directory is None:
                self.directory = tempfile.mkdtemp(prefix="repro-spill-")
            if disk_free(self.directory) - need < DISK_RESERVE_BYTES:
                self.stats.kept += 1
                return
            host = self.copier.to_file(leaves, ready, self.directory)
            self.stats.to_disk += 1
        msg.value = tree_unflatten(msg.value, host)
        self.stats.spilled_bytes += need

    def run(self, work: "queue.Queue") -> None:
        """Each message of ``work`` in turn, until None; a copy that raises
        leaves its payload on the card, and ``release`` raises it."""
        while True:
            item = work.get()
            if item is None:
                break
            need = _payload_bytes(item[0].value)
            try:
                self.spill(*item, need)
            except Exception as e:
                self.stats.error = e
            finally:
                item = None  # hold nothing of the card's between messages
                self.pending.done(need)
                work.task_done()
        if self.directory is not None:
            shutil.rmtree(self.directory, ignore_errors=True)


def _stop(work: "queue.Queue", thread: threading.Thread) -> None:
    """End the worker ``thread`` once it has finished what it took."""
    work.put(None)
    if thread is not threading.current_thread():
        thread.join()


class HostSpill:
    """Moves payloads of messages from the card to the host (module
    docstring)."""

    def __init__(self):
        self.stats = Stats()
        self._pending = _Pending()
        self._held: list = []
        self._lock = threading.Lock()
        self._work: Optional[queue.Queue] = None
        self._standby = False

    def takes(self, value) -> bool:
        """Whether ``value`` is a tree of tensors all on one card."""
        leaves = tree_leaves(value)
        return bool(leaves) and all(
            isinstance(t, torch.Tensor) and t.is_cuda
            and t.device == leaves[0].device for t in leaves)

    def ready(self, value) -> torch.cuda.Event:
        """An event on the current stream of ``value``'s card: its copy
        waits for it."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(tree_leaves(value)[0].device))
        return ev

    def spare(self):
        """What the spill asks how many bytes a payload's card can spare
        beyond its reserve: ``card_spare``."""
        return card_spare

    def budget(self, value) -> int:
        """Bytes of payloads that may wait on ``value``'s card, ``value``
        among them: those waiting now, and what the card can spare."""
        return (self._pending.bytes + _payload_bytes(value)
                + self.spare()(value))

    def standby(self, value, need: int) -> None:
        """Give the allocator of ``value``'s card, on its current stream,
        the bytes of ``STANDBY_PAYLOADS`` payloads of ``need`` bytes, or of
        as many as the card can spare: a block taken and freed at once,
        which its cache keeps and splits for the payloads to come."""
        leaves = tree_leaves(value)
        if not leaves[0].is_cuda:
            return
        n = min(STANDBY_PAYLOADS, max(self.spare()(value), 0) // max(need, 1))
        if n:
            torch.empty(n * need, dtype=torch.uint8, device=leaves[0].device)

    def copier(self) -> "StagedCopy":
        """What the worker copies with: ``to_memory(leaves, ready)`` and
        ``to_file(leaves, ready, directory)``."""
        return StagedCopy()

    def hold(self, msg) -> None:
        """Keep ``msg``, whose value ``takes``, for the next ``release``.
        Waits first while the payloads pending would pass the budget with
        this one: where the host moves payloads slower than they come, the
        caller slows to its pace (``stats.waited_s``) and the card does not
        fill."""
        need = _payload_bytes(msg.value)
        if not self._standby:
            self._standby = True
            self.standby(msg.value, need)
        budget = self.budget(msg.value)
        t0 = time.perf_counter()
        self._pending.take(need, budget)
        self.stats.waited_s += time.perf_counter() - t0
        ready = self.ready(msg.value)
        with self._lock:
            self._held.append((msg, ready))

    def release(self) -> None:
        """Hand every held message to the worker, which starts at the
        first; raises what a copy raised."""
        if self.stats.error is not None:
            raise RuntimeError("moving a payload off the card failed") \
                from self.stats.error
        with self._lock:
            held, self._held = self._held, []
        if not held:
            return
        if self._work is None:
            self._work = queue.Queue()
            worker = threading.Thread(
                target=_Worker(self.copier(), self.spare(), self.stats,
                               self._pending).run,
                args=(self._work,), daemon=True, name="host-spill")
            worker.start()
            weakref.finalize(self, _stop, self._work, worker)
        for item in held:
            self._work.put(item)

    def wait(self) -> None:
        """Block until the worker has finished every released message."""
        if self._work is not None:
            self._work.join()
