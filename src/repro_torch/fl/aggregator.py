"""Aggregation executor: consumes model updates from the message queue,
folds them into a (checkpointable, mergeable) FusionState using the fusion
kernels, and produces the fused global model.

Supports the three behaviours JIT scheduling needs:
  * incremental folding (updates fused as they arrive — streaming container)
  * preemption: partial FusionState checkpointed to / resumed from the queue
  * parallel aggregation: shard updates over N workers, merge partials
    (linearity of ⊕ guarantees the same result).

With a wall-clock ``Tracer`` a ``drain`` is an ``agg.drain`` span whose
children are the queue's ``queue.poll`` and one ``agg.fold`` a message
folded (its ``pair_fuse`` launches and its queue wait), and
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
from repro_torch.kernels.pair_fuse import pair_fuse
from repro_torch.obs.trace import NULL_TRACER, wall_clock


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
        """Fold all pending updates for `round_idx` from the queue."""
        tr = self.tracer
        sid = allocs = None
        if tr.enabled:
            allocs = _device_allocs()
            sid = tr.open("agg", "drain", self.job_id, round_idx)
        topic = self.queue.topic(f"updates/{self.job_id}")
        msgs = self.queue.poll_updates(self.job_id, self.group, max_messages,
                                       parent=sid)
        n = 0
        for m in msgs:
            if m.value["round"] != round_idx:
                topic.commit(self.group, m.offset)  # stale round: drop
                continue
            w = self.alg.weight_of(m.value.get("n_examples", 1))
            if tr.enabled:
                self._fold_traced(m, w, sid)
            else:
                self.state = self.state.fold(m.value["update"], w)
            topic.commit(self.group, m.offset)
            n += 1
        if tr.enabled:
            tr.close(sid, folded=n, stale=len(msgs) - n,
                     **self._allocs_since(allocs))
        return n

    def _fold_traced(self, m, w: float, parent: int) -> None:
        """``drain``'s fold of message ``m`` as an ``agg.fold`` span: the
        ``pair_fuse`` launches it made, and ns from the message's
        timestamp to the fold's start."""
        tr = self.tracer
        sid = tr.open("agg", "fold", parent=parent)
        launches = pair_fuse.launches
        self.state = self.state.fold(m.value["update"], w)
        tr.close(sid, launches=pair_fuse.launches - launches,
                 wait_ns=tr.start_ns(sid) - round(m.timestamp * 1e9))

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
        the accumulator by reference, which is why folding is out of place."""
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
