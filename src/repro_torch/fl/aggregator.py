"""Aggregation executor: consumes model updates from the message queue,
folds them into a (checkpointable, mergeable) FusionState using the fusion
kernels, and produces the fused global model.

Supports the three behaviours JIT scheduling needs:
  * incremental folding (updates fused as they arrive — streaming container)
  * preemption: partial FusionState checkpointed to / resumed from the queue
  * parallel aggregation: shard updates over N workers, merge partials
    (linearity of ⊕ guarantees the same result).

``drain`` folds a backlog up to ``FOLD_WIDTH`` updates a ``batch_fold``
launch; ``aggregate`` and ``FusionState.merge`` fold with ``pair_fuse``.

With a wall-clock ``Tracer`` a ``drain`` is an ``agg.drain`` span whose
children are the queue's ``queue.poll`` and one ``agg.fold`` a batch
folded (its ``batch_fold`` launches, its updates and its first message's
queue wait), and
``finish_round`` an ``agg.finish`` span timed on the card by two CUDA
events. On the card both count the allocator's ``cudaMalloc`` calls
(``alloc.device_allocs``) at their open and close only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import Pytree
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.fusion import FusionAlgorithm, FusionState, get_algorithm
from repro_torch.kernels.batch_fold import C_MAX, batch_fold
from repro_torch.obs.trace import NULL_TRACER, wall_clock

#: updates ``drain`` folds a launch: the most ``batch_fold`` takes
FOLD_WIDTH = C_MAX


def _device_allocs() -> Optional[int]:
    """The caching allocator's ``cudaMalloc`` calls so far; None before
    the process has used the card."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats()["num_device_alloc"]


class AggregationExecutor:
    def __init__(
        self,
        job_id: str,
        algorithm: str | FusionAlgorithm = "fedavg",
        queue: Optional[MessageQueue] = None,
        *,
        n_workers: int = 1,
        group: str = "aggregator",
        tracer=NULL_TRACER,
    ):
        self.tracer = wall_clock(tracer)
        self.job_id = job_id
        self.alg = (get_algorithm(algorithm)
                    if isinstance(algorithm, str) else algorithm)
        self.queue = queue or MessageQueue()
        self.n_workers = max(1, n_workers)
        self.group = group
        self.state = FusionState()

    # ---- queue-driven incremental path ---------------------------------------
    def drain(self, round_idx: int, max_messages: int = 1 << 30) -> int:
        """Fold all pending updates for `round_idx` from the queue.

        The kept messages are folded in message order, ``FOLD_WIDTH`` at a
        time (fewer in the last batch), one ``batch_fold`` launch a batch:
        the same bits as folding them one by one. The drain's first batch
        writes a new accumulator (a checkpoint may hold the old one); its
        later batches update that one in place. Each message is committed
        once the batch that holds it, or that follows it if it is stale, is
        folded."""
        tr = self.tracer
        sid = allocs = None
        if tr.enabled:
            allocs = _device_allocs()
            sid = tr.open("agg", "drain", self.job_id, round_idx)
        topic = self.queue.topic(f"updates/{self.job_id}")
        msgs = self.queue.poll_updates(self.job_id, self.group, max_messages,
                                       parent=sid)
        n = 0
        batch = []
        for i, m in enumerate(msgs):
            if m.value["round"] == round_idx:  # else a stale round: dropped
                batch.append(m)
            if len(batch) == FOLD_WIDTH or i == len(msgs) - 1:
                if batch:
                    self._fold(batch, n > 0, sid)
                    n += len(batch)
                    batch = []
                topic.commit(self.group, m.offset)
        if tr.enabled:
            tr.close(sid, folded=n, stale=len(msgs) - n,
                     **self._allocs_since(allocs))
        return n

    def _fold(self, batch, in_place: bool, parent: Optional[int]) -> None:
        """Fold the messages ``batch`` into the state; traced, an
        ``agg.fold`` span: the ``batch_fold`` launches it made, the updates
        it folded, and ns from the first message's timestamp to its
        start."""
        ups = [m.value["update"] for m in batch]
        ws = [self.alg.weight_of(m.value.get("n_examples", 1)) for m in batch]
        tr = self.tracer
        if not tr.enabled:
            self.state = self.state.fold_batch(ups, ws, in_place=in_place)
            return
        sid = tr.open("agg", "fold", parent=parent)
        launches = batch_fold.launches
        self.state = self.state.fold_batch(ups, ws, in_place=in_place)
        tr.close(sid, launches=batch_fold.launches - launches,
                 updates=len(batch),
                 wait_ns=tr.start_ns(sid) - round(batch[0].timestamp * 1e9))

    def _allocs_since(self, allocs: Optional[int]) -> dict:
        """``device_allocs``, the allocator's ``cudaMalloc`` calls since
        the reading ``allocs``, added to the counter
        ``alloc.device_allocs``; nothing off the card."""
        if allocs is None:
            return {}
        d = _device_allocs() - allocs
        self.tracer.metrics.counter("alloc.device_allocs").inc(d)
        return {"device_allocs": d}

    def checkpoint(self) -> None:
        """Preemption: persist the partial aggregate (§5.5). The queue holds
        the accumulator by reference, which is why a drain's first batch
        writes a new one."""
        self.queue.checkpoint_partial(
            self.job_id,
            {"acc": self.state.acc, "total_weight": self.state.total_weight,
             "n_fused": self.state.n_fused},
        )

    def resume(self) -> bool:
        snap = self.queue.latest_partial(self.job_id)
        if snap is None:
            return False
        self.state = FusionState(
            acc=snap["acc"], total_weight=snap["total_weight"],
            n_fused=snap["n_fused"],
        )
        return True

    def finish_round(self, global_model: Pytree, round_idx: int,
                     lr: float = 1.0) -> Pytree:
        tr = self.tracer
        if tr.enabled:
            allocs = _device_allocs()
            sid = tr.open("agg", "finish", self.job_id, round_idx,
                          device=allocs is not None)
        fused = self.state.result()
        new_model = self.alg.apply(global_model, fused, lr)
        self.queue.publish_fused(self.job_id, round_idx, new_model)
        self.state = FusionState()
        if tr.enabled:
            tr.close(sid, **self._allocs_since(allocs))
        return new_model

    # ---- batch path (lazy / batched strategies, and tests) -----------------------
    def aggregate(
        self,
        updates: Sequence[Pytree],
        n_examples: Sequence[int],
        global_model: Optional[Pytree] = None,
        lr: float = 1.0,
    ) -> Pytree:
        """Fuse a batch of updates, optionally sharded over n_workers
        partial aggregates that are then merged (parallel aggregation)."""
        if not len(updates) == len(n_examples) >= 1:
            raise ValueError("need one n_examples per update, at least one")
        ws = [self.alg.weight_of(n) for n in n_examples]
        if self.n_workers == 1:
            st = FusionState()
            for u, w in zip(updates, ws):
                st = st.fold(u, w)
        else:
            partials: List[FusionState] = []
            for s in range(self.n_workers):
                p = FusionState()
                for u, w in list(zip(updates, ws))[s::self.n_workers]:
                    p = p.fold(u, w)
                if p.acc is not None:
                    partials.append(p)
            st = partials[0]
            for p in partials[1:]:
                st = st.merge(p)
        fused = st.result()
        if global_model is None:
            return fused
        return self.alg.apply(global_model, fused, lr)
