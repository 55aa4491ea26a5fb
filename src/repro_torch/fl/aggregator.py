"""Aggregation executor: consumes model updates from the message queue,
folds them into a (checkpointable, mergeable) FusionState using the fusion
kernels, and produces the fused global model.

Supports the three behaviours JIT scheduling needs:
  * incremental folding (updates fused as they arrive — streaming container)
  * preemption: partial FusionState checkpointed to / resumed from the queue
  * parallel aggregation: shard updates over N workers, merge partials
    (linearity of ⊕ guarantees the same result).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch import Pytree
from repro_torch.core.queue import MessageQueue
from repro_torch.fl.fusion import FusionAlgorithm, FusionState, get_algorithm


class AggregationExecutor:
    def __init__(
        self,
        job_id: str,
        algorithm: str | FusionAlgorithm = "fedavg",
        queue: Optional[MessageQueue] = None,
        *,
        n_workers: int = 1,
        group: str = "aggregator",
    ):
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
        topic = self.queue.topic(f"updates/{self.job_id}")
        msgs = topic.poll(self.group, max_messages)
        n = 0
        for m in msgs:
            if m.value["round"] != round_idx:
                topic.commit(self.group, m.offset)  # stale round: drop
                continue
            w = self.alg.weight_of(m.value.get("n_examples", 1))
            self.state = self.state.fold(m.value["update"], w)
            topic.commit(self.group, m.offset)
            n += 1
        return n

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
        fused = self.state.result()
        new_model = self.alg.apply(global_model, fused, lr)
        self.queue.publish_fused(self.job_id, round_idx, new_model)
        self.state = FusionState()
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
