"""Traffic kind ``agg_backlog``: the aggregator deployed just in time
finds a round's updates queued, and fuses the backlog.

The benchmark plays the parties. Set-up draws the global model and a pool
of ``pool`` distinct update trees on the device from the seed. Each round
publishes ``updates`` messages through ``MessageQueue.publish_update``,
each an update of the pool in an order drawn from the seed, with a number
of examples drawn from [``min_examples``, ``max_examples``]; then
``AggregationExecutor.drain`` and ``finish_round`` fuse them into the new
global model, and the device is synchronised. Every seed does the same
work (the same sizes) in another order. ``warmup_rounds`` rounds run in
set-up.

``correct``: in ``checked_rounds`` rounds of the window drawn from the
seed, every leaf of the new global model that ``finish_round`` returned
against the float64 examples-weighted mean of the same updates, by the
largest gap over the leaf's root mean square. The rounds are drawn as the
window runs (a reservoir sample), and the benchmark keeps only their
models, so what the card holds beyond them is the program's."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from fedbench import counts, weights
from fedbench.reference import fl as ref_fl

F64 = torch.float64


def fold_gap(fused: List[torch.Tensor], expect: List[torch.Tensor]) -> float:
    """max over leaves of max|fused - expect| / rms(expect)."""
    worst = 0.0
    for f, e in zip(fused, expect):
        e = e.to(F64)
        rms = float(torch.sqrt(torch.mean(e * e)))
        worst = max(worst, float((f.to(F64) - e).abs().max()) / max(rms,
                                                                    1e-30))
    return worst


class Traffic:
    unit = "updates"
    window = False  # set while the window runs; its rounds may be checked

    def __init__(self, cell: Dict, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, device
        self.leaves = config["leaves"]
        self.n_params = counts.count_elems(self.leaves)
        self.rng = np.random.default_rng(seed)
        self.pick_rng = np.random.default_rng(seed + 1)
        self.trace_spans = False
        self.seen = 0  # window rounds so far
        self.kept: Dict[int, Dict] = {}  # checked round -> its new model

    def setup(self) -> None:
        from repro_torch.core.queue import MessageQueue
        from repro_torch.fl.aggregator import AggregationExecutor
        from repro_torch.kernels.pair_fuse import pair_fuse

        t = self.traffic
        self._pair_fuse = pair_fuse
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.global_model = weights.make_model(self.config, gen, self.device)
        self.pool = weights.make_pool(self.config, t["pool"], gen,
                                      self.device)
        self.pool_trees = [weights.nest(self.leaves, p) for p in self.pool]
        self.job = self.cell["name"]
        self.queue = MessageQueue()
        self.agg = AggregationExecutor(self.job, t["algorithm"], self.queue)
        self.rounds: List[Dict] = []  # what each round published
        for _ in range(t["warmup_rounds"]):
            self.step()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> Dict:
        t = self.traffic
        r = len(self.rounds)
        picks = self.rng.integers(0, t["pool"], size=t["updates"])
        n_ex = self.rng.integers(t["min_examples"], t["max_examples"] + 1,
                                 size=t["updates"])
        self.rounds.append({"picks": picks, "n_examples": n_ex})
        launches = self._pair_fuse.launches
        for i, (j, n) in enumerate(zip(picks, n_ex)):
            self.queue.publish_update(self.job, f"p{i}",
                                      self.pool_trees[int(j)], r, int(n))
        t0 = time.perf_counter()
        folded = self.agg.drain(r)
        if self.trace_spans:
            self._sync()
        drain_s = time.perf_counter() - t0
        self.global_model = self.agg.finish_round(self.global_model, r)
        if self.window:
            self._offer(r)
        self._sync()
        mem = (torch.cuda.memory_allocated(self.device)
               if self.device.type == "cuda" else 0)
        return {"units": int(folded), "attempted": int(t["updates"]),
                "mem_bytes": mem, "drain_s": drain_s if self.trace_spans
                else None, "round": r,
                "pair_fuse_launches": self._pair_fuse.launches - launches}

    def record(self) -> Dict:
        t = self.traffic
        return {
            "n_leaves": len(self.leaves),
            "fold_bytes": counts.fold_bytes(self.n_params),
            "round_min_bytes": counts.round_min_bytes(self.n_params,
                                                      t["updates"]),
        }

    # ---- correct ------------------------------------------------------------
    def _offer(self, r: int) -> None:
        """Reservoir sampling of the window's rounds: after n rounds each
        is kept with chance ``checked_rounds`` / n; a round that drops out
        drops its model."""
        k = self.traffic["checked_rounds"]
        if self.seen < k:
            self.kept[r] = self.global_model
        else:
            j = int(self.pick_rng.integers(0, self.seen + 1))
            if j < k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[r] = self.global_model
        self.seen += 1

    def free(self) -> None:
        """Drop the program's state, keeping the new global models of the
        checked rounds."""
        self.outputs = {r: weights.flatten(m, self.leaves)
                        for r, m in self.kept.items()}
        self.queue = self.agg = self.global_model = self.pool_trees = None
        self.kept = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, r: int, leaf: int, accumulator=None) -> torch.Tensor:
        rd = self.rounds[r]
        pool_leaf = [p[leaf] for p in self.pool]
        if accumulator is None:
            return ref_fl.weighted_mean(pool_leaf, rd["picks"],
                                        rd["n_examples"])
        return ref_fl.sequential_fold(pool_leaf, rd["picks"],
                                      rd["n_examples"], accumulator)

    def check(self, window_rounds: List[int]) -> Dict[str, float]:
        if not set(self.kept) <= set(window_rounds):
            raise ValueError("a checked round is not a window round")
        self.free()
        worst = 0.0
        for r in sorted(self.outputs):
            expect = [self.expected(r, i) for i in range(len(self.leaves))]
            worst = max(worst, fold_gap(self.outputs[r], expect))
            del expect
        return {"fold_gap": worst}

    def control(self, window_rounds: List[int]) -> Dict[str, float]:
        """The control's reading: the fold with a bf16 accumulator, its
        result cast to the model's dtype, against the reference."""
        self.free()
        dtype = weights.DTYPES[self.config["run"]["dtype"]]
        worst = 0.0
        for r in sorted(self.outputs):
            for i in range(len(self.leaves)):
                ctl = self.expected(r, i, torch.bfloat16).to(dtype)
                worst = max(worst, fold_gap([ctl], [self.expected(r, i)]))
        return {"fold_gap": worst}
