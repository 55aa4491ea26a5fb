"""The port's whole slice against the JAX package's: ``FLJobRuntime`` with 3
parties and 2 FedAvg rounds, both started from the reference's initial
weights and fed the same numpy-seeded data, compared round by round; and
``replay_measured`` on the same measured arrivals in both packages.

The runtimes are compared in fp32, where the point is the algorithm (the
bf16 arithmetic of one step is held in ``test_torch_model.py``). Fused
global parameters and the eval loss agree within rtol 1e-4 / atol 1e-5:
two rounds of local SGD, summed in other orders, then one fp32 fold per
party. Timing-derived fields (arrivals, predictions) come from each
package's own wall clock and are not compared; the replay, which is
deterministic given the same arrivals, must agree exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import replay_measured as j_replay_measured
from repro.core.estimator import AggregationEstimator as JAggregationEstimator
from repro.core.jobspec import FLJobSpec as JFLJobSpec
from repro.core.jobspec import PartySpec as JPartySpec
from repro.fl.job import FLJobRuntime as JFLJobRuntime
from repro_torch import configs, interop, tree_leaves
from repro_torch.api import Platform, replay_measured
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.core.policy import available_strategies
from repro_torch.models import model as M

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()
KW = dict(n_sequences=48, eval_sequences=16, seed=0)


def _spec(cls, pcls, cfg, rounds=2):
    return cls(
        job_id="it", model_arch=cfg.name, model_bytes=M.n_params(cfg) * 4,
        aggregation_algorithm="fedavg", rounds=rounds, lr=0.05, batch_size=8,
        parties={f"p{i}": pcls(f"p{i}") for i in range(3)},
    )


@pytest.fixture(scope="module")
def runs():
    """Both runtimes, 2 rounds each: (reference runtime, port's
    TrainingResult, {"ref"/"port": [(eval loss, global params) per round]})
    with the reference's list starting at its initial model."""
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(**kw)
    cfg = configs.get_config("qwen3-0.6b").reduced(**kw)
    # the reference's t_pair probe is not what is compared: skip it
    jrt = JFLJobRuntime(jcfg, _spec(JFLJobSpec, JPartySpec, cfg),
                        interpret=True, estimator=JAggregationEstimator(0.01),
                        **KW)
    init = interop.to_torch(jax.tree.map(np.asarray, jrt.global_params), "cpu")
    ref = [(jrt.eval_loss(), jrt.global_params)]
    for r in range(2):
        ref.append((jrt.run_round(r).global_loss, jrt.global_params))
    res = Platform().train(cfg, _spec(FLJobSpec, PartySpec, cfg),
                           device="cpu", initial_params=init, **KW)
    fused = [m.value for m in res.runtime.queue.topic("fused/it").poll("test")]
    port = [(r.global_loss, p) for r, p in zip(res.records, fused)]
    return jrt, res, {"ref": ref, "port": port}


def test_runtime_matches_reference_round_by_round(runs):
    jrt, res, steps = runs
    assert [r.round_idx for r in res.records] == [0, 1]
    assert res.metrics.rounds_done == 2
    for (jloss, jparams), (loss, params) in zip(steps["ref"][1:],
                                                steps["port"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
        for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params)):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
    # learning happened, in both
    assert steps["port"][-1][0] < steps["ref"][0][0]
    assert res.runtime.records[-1].global_loss == steps["port"][-1][0]


def test_runtime_reports_what_the_schedule_needs(runs):
    jrt, res, _ = runs
    rt = res.runtime
    assert rt.t_pair0 > 0
    assert len(rt.measured_rounds) == 2
    for measured, rec in zip(rt.measured_rounds, res.records):
        assert set(measured) == {"p0", "p1", "p2"}
        for pid, (train_s, comm_s) in measured.items():
            assert train_s > 0 and comm_s >= 0
            assert rec.arrivals[pid] == pytest.approx(train_s + comm_s)
        assert rec.latency >= 0 and rec.container_seconds > 0
    for p in rt.spec.parties.values():
        assert p.minibatch_time_s > 0 and p.dataset_size == 16
    # every round's three updates went through the queue and were folded
    assert len(rt.queue.topic("updates/it")) == 6
    assert rt.queue.topic("updates/it").lag("aggregator") == 0


@pytest.mark.parametrize("policy", available_strategies() + ("fixed-jit",))
def test_replay_measured_equals_reference(runs, policy):
    _, res, _ = runs
    measured = res.runtime.measured_rounds
    pol = None if policy == "fixed-jit" else policy
    spec = res.runtime.spec  # with the parties' measured timing reports
    jspec = JFLJobSpec(**{
        **dataclasses.asdict(spec),
        "parties": {pid: JPartySpec(**dataclasses.asdict(p))
                    for pid, p in spec.parties.items()}})
    got = replay_measured(spec, measured, pol, t_pair_s=0.01)
    want = j_replay_measured(jspec, measured, pol, t_pair_s=0.01)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rounds_done == 2


def test_runtime_rejects_out_of_order_rounds():
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=1, d_model=32, vocab_size=64, d_ff=64)
    platform_rt = Platform().train(cfg, _spec(FLJobSpec, PartySpec, cfg,
                                              rounds=1),
                                   device="cpu", n_sequences=6,
                                   eval_sequences=2).runtime
    with pytest.raises(ValueError, match="only 1 rounds"):
        platform_rt.run_round(1)
    with pytest.raises(ValueError, match="in order"):
        platform_rt.run_round(0)
