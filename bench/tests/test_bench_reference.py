"""The reference's weighted mean is the aggregator's FedAvg on small CPU
inputs, and the aggregator cells keep the models of the rounds they check
and no others."""
import collections

import numpy as np
import torch

from fedbench.kinds import agg_backlog
from fedbench.reference import fl as ref_fl

SEED = 2**31 + 77


def test_weighted_mean_is_the_aggregators_fedavg():
    from repro_torch.fl.aggregator import AggregationExecutor

    g = torch.Generator().manual_seed(SEED)
    pool = [torch.randn(1000, generator=g).to(torch.bfloat16)
            for _ in range(5)]
    picks = [0, 3, 3, 1, 4, 2, 0]
    n_ex = [100, 250, 999, 1000, 512, 300, 128]
    fused = AggregationExecutor("j").aggregate(
        [{"w": pool[j]} for j in picks], n_ex)["w"]
    ref = ref_fl.weighted_mean(pool, picks, n_ex)
    torch.testing.assert_close(fused.double(), ref, rtol=1e-6, atol=1e-7)
    bf16 = ref_fl.sequential_fold(pool, picks, n_ex, torch.bfloat16)
    assert (bf16.double() - ref).abs().max() > (fused.double()
                                                - ref).abs().max()


def _sampler(seed, checked=3):
    """An aggregator cell's round sampler alone, its models stand-ins."""
    drv = agg_backlog.Traffic.__new__(agg_backlog.Traffic)
    drv.traffic = {"checked_rounds": checked}
    drv.pick_rng = np.random.default_rng(seed + 1)
    drv.seen, drv.kept = 0, {}
    return drv


def _kept_after(seed, rounds, checked=3):
    drv = _sampler(seed, checked)
    for r in range(rounds):
        drv.global_model = object()
        drv._offer(r)
    return drv


def test_the_checked_rounds_are_a_uniform_sample_of_the_window():
    n, seeds = 10, 3000
    hits = collections.Counter()
    for s in range(seeds):
        kept = sorted(_kept_after(2**31 + s, n).kept)
        assert len(kept) == 3 and len(set(kept)) == 3
        hits.update(kept)
    for r in range(n):  # 0.3 each; 4 standard deviations
        assert abs(hits[r] / seeds - 0.3) < 4 * (0.3 * 0.7 / seeds) ** 0.5
    assert sorted(_kept_after(SEED, n).kept) == \
        sorted(_kept_after(SEED, n).kept)


def test_only_the_checked_rounds_models_are_held(tiny):
    from fedbench import layout

    cell = "agg_backlog.mamba2-130m"
    config, traffic = tiny(cell)
    drv = agg_backlog.Traffic({"name": cell}, layout.with_leaves(config),
                              dict(traffic, updates=4), SEED,
                              torch.device("cpu"))
    drv.setup()
    assert drv.kept == {}  # warm-up rounds are never checked
    drv.window = True
    models = []
    for _ in range(8):
        drv.step()
        models.append(drv.global_model)
    drv.window = False
    drv.step()  # a round after the window, as the traced one
    window = list(range(traffic["warmup_rounds"],
                        traffic["warmup_rounds"] + 8))
    assert len(drv.kept) == 3 and set(drv.kept) <= set(window)
    for r, m in drv.kept.items():
        assert m is models[r - window[0]]
    assert drv.check(window)["fold_gap"] <= traffic["limits"]["fold_gap"]
