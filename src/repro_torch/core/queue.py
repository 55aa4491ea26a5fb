"""Durable message queue for model updates and partial-aggregate checkpoints.

Stands in for the paper's Kafka + cloud-object-store combination: any
dynamic deployment strategy (eager-serverless, batched, lazy, JIT) requires
updates to be buffered in the datacenter while no aggregator is deployed,
and preemption (§5.5) requires checkpointing partially-aggregated state.

Semantics: append-only per-topic logs, at-least-once consumption via
explicit offset commits, optional file-backed persistence.

With a wall-clock ``Tracer`` the queue records a ``queue.publish`` span
for each ``publish_update`` and a ``queue.poll`` span for each
``poll_updates``; with the default ``NULL_TRACER`` it reads no clock.

A fused model published on the card moves off it, to host memory or disk
(``spill``, a ``core.spill.HostSpill``): it is held at ``publish_fused``
and released to the spill's thread at the next ``poll_updates``, so its
copy overlaps the next drain's folds. Offsets, keys, order and what a poll
returns stay the same; the payload is never dropped.
"""
from __future__ import annotations

import dataclasses
import io
import json
import pickle
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.spill import HostSpill
from repro_torch.obs.trace import NULL_TRACER, wall_clock


@dataclasses.dataclass
class Message:
    offset: int
    key: str
    value: Any
    timestamp: float


class Topic:
    def __init__(self, name: str, persist_dir: Optional[Path] = None):
        self.name = name
        self._log: List[Message] = []
        self._committed: Dict[str, int] = {}  # consumer group -> next offset
        self._lock = threading.Lock()
        self._persist = persist_dir / f"{name}.log" if persist_dir else None
        if self._persist and self._persist.exists():
            self._load()

    def append(self, key: str, value: Any, timestamp: Optional[float] = None) -> int:
        with self._lock:
            off = len(self._log)
            msg = Message(off, key, value, timestamp if timestamp is not None
                          else time.time())
            self._log.append(msg)
            if self._persist:
                with open(self._persist, "ab") as f:
                    pickle.dump(msg, f)
            return off

    def poll(self, group: str, max_messages: int = 1 << 30) -> List[Message]:
        """Read uncommitted messages for a consumer group (does not commit)."""
        with self._lock:
            start = self._committed.get(group, 0)
            return self._log[start : start + max_messages]

    def commit(self, group: str, upto_offset: int) -> None:
        with self._lock:
            cur = self._committed.get(group, 0)
            self._committed[group] = max(cur, upto_offset + 1)

    def lag(self, group: str) -> int:
        with self._lock:
            return len(self._log) - self._committed.get(group, 0)

    def __len__(self) -> int:
        return len(self._log)

    def _load(self) -> None:
        with open(self._persist, "rb") as f:
            while True:
                try:
                    self._log.append(pickle.load(f))
                except EOFError:
                    break


class MessageQueue:
    """Topic registry. Conventional topics per FL job:

      updates/<job_id>     — model updates from parties
      partial/<job_id>     — checkpointed partial aggregates (preemption)
      fused/<job_id>       — per-round fused global models
    """

    def __init__(self, persist_dir: Optional[str] = None, *,
                 tracer=NULL_TRACER):
        self.tracer = wall_clock(tracer)
        self.spill = HostSpill()
        self._dir = Path(persist_dir) if persist_dir else None
        if self._dir:
            self._dir.mkdir(parents=True, exist_ok=True)
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> Topic:
        with self._lock:
            if name not in self._topics:
                safe = name.replace("/", "__")
                self._topics[name] = Topic(safe, self._dir)
            return self._topics[name]

    # convenience wrappers -------------------------------------------------
    def publish_update(self, job_id: str, party_id: str, update: Any,
                       round_idx: int, n_examples: int = 1,
                       timestamp: Optional[float] = None) -> int:
        tr = self.tracer
        if tr.enabled:
            sid = tr.open("queue", "publish", job_id, round_idx)
        off = self.topic(f"updates/{job_id}").append(
            party_id,
            {"round": round_idx, "update": update, "n_examples": n_examples},
            timestamp,
        )
        if tr.enabled:
            tr.close(sid, offset=off)
        return off

    def poll_updates(self, job_id: str, group: str,
                     max_messages: int = 1 << 30,
                     parent: Optional[int] = None) -> List[Message]:
        """``Topic.poll`` of ``updates/<job_id>``; traced as ``queue.poll``
        under the span ``parent`` (its job and round)."""
        self.spill.release()
        tr = self.tracer
        if tr.enabled:
            sid = tr.open("queue", "poll", job_id, parent=parent)
        msgs = self.topic(f"updates/{job_id}").poll(group, max_messages)
        if tr.enabled:
            tr.close(sid, messages=len(msgs))
        return msgs

    def checkpoint_partial(self, job_id: str, state: Any,
                           timestamp: Optional[float] = None) -> int:
        return self.topic(f"partial/{job_id}").append("partial", state, timestamp)

    def latest_partial(self, job_id: str) -> Optional[Any]:
        t = self.topic(f"partial/{job_id}")
        return t._log[-1].value if len(t) else None

    def publish_fused(self, job_id: str, round_idx: int, model: Any,
                      timestamp: Optional[float] = None) -> int:
        """Append ``model`` to ``fused/<job_id>``; a model on the card is
        held for the spill (module docstring)."""
        t = self.topic(f"fused/{job_id}")
        off = t.append(str(round_idx), model, timestamp)
        if self.spill.takes(model):
            self.spill.hold(t._log[off])
        return off
