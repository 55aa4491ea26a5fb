"""The port's examples against the reference's (``examples/*.py``) on the CPU,
and the t_pair probe's sizing (``quickstart`` is held in
``test_torch_quickstart.py``, the same way).

``multijob_scheduler`` and ``quickstart.simulate`` run on the virtual clock
in both packages: their printed reports and their metrics must be equal
(``==``). ``quickstart.train`` and ``federated_100m.run`` train for real:
each runs at a reduced fp32 config against the JAX package's
``Platform.train`` on the same config, spec and initial weights, and the
eval loss after each round agrees within rtol 1e-4 / atol 1e-5, as
``test_torch_job.py`` holds the runtime, and each round's fused model
within rtol 1e-4 and 1e-4 of the leaf's largest magnitude, as
``test_torch_families_job.py`` holds models without qk_norm (for
federated_100m, the first round only: its docstring says why). Fields that
come from the wall clock (arrivals, predictions, container-seconds) are not
compared.
"""
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs, interop, tree_leaves
from repro_torch.api import Platform
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.examples import federated_100m, multijob_scheduler
from repro_torch.fl import job as job_mod
from repro_torch.kernels import ops
from repro_torch.models import model as M
from _torch_examples import (  # noqa: F401 (reference_runs is a fixture)
    _assert_runs_agree, _reference, _reference_train, _run, reference_runs)
from _torch_parity import plain

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()


def test_multijob_scheduler_equals_reference(reference_runs):
    want_text, _ = _run(_reference("multijob_scheduler").main)
    text, (platform, metrics) = _run(multijob_scheduler.main)
    assert text == want_text
    assert "preemptions" in text and "rounds aggregated: 12" in text
    assert [plain(metrics)] == plain(reference_runs)


def test_federated_100m_run_matches_reference():
    """example-100m reduced (2 layers, d_model 64, vocab 128, fp32), 4
    parties, FedProx (mu 0.001), 2 rounds of 48 sequences. The first round
    is held as the quickstart's rounds are; the second round's eval loss
    within rtol 1e-2: without qk_norm the reference's init gives sharply
    peaked attention, and at the example's lr of 0.05 the reference's own
    second-round eval loss moves by 2.2e-3 of itself (and its parameters
    by 2.3 % of a leaf's scale) when its initial weights are scaled by
    1 + 1e-7."""
    kw = dict(num_layers=2, d_model=64, vocab_size=128, dtype="float32")
    jcfg = jconfigs.get_config("example-100m").reduced(**kw)
    cfg = configs.get_config("example-100m").reduced(**kw)
    jres, init = _reference_train(
        jcfg, dict(job_id="federated-100m", model_arch=cfg.name,
                   model_bytes=M.n_params(cfg) * 4, rounds=2, lr=0.05,
                   batch_size=8, aggregation_algorithm="fedprox",
                   prox_mu=0.001, n_parties=4),
        n_sequences=48, eval_sequences=32)
    text, out = _run(lambda: federated_100m.run(
        cfg, rounds=2, n_sequences=48, device="cpu",
        initial_params=interop.to_torch(init, "cpu")))
    res = out["result"]
    _assert_runs_agree(jres, res, tight_rounds=1)
    assert out["final_loss"] == res.records[-1].global_loss
    assert out["t_rnd_pred_err"] is not None and out["t_rnd_pred_err"] >= 0
    assert res.metrics.strategy == "jit"
    assert "final eval loss" in text and "prediction error" in text


# --------------------------------------------------------------------------
# the t_pair probe times the real fold
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_probe_sizes_its_operands_from_the_leaves(dtype, monkeypatch):
    """The probe is the streaming fold (``ops.accumulate``, one
    pair_fuse launch over every leaf) of an update in the model's dtype into an fp32
    accumulator with the model's leaf sizes: the operands of the
    aggregator's folds, leaf for leaf, which a drain makes in one
    ``batch_fold`` launch of its updates. The CPU caps the accumulator at
    CPU_PROBE_CAP bytes, every leaf cut by the same factor, and scales the
    time by the elements left out."""
    cfg = configs.get_config("qwen3-0.6b").reduced(
        num_layers=1, d_model=32, vocab_size=64, d_ff=64, dtype=dtype)
    calls, batches = [], []
    real, real_batch = ops.pair_fuse_many, ops.batch_fold

    def spy(a_list, b_list, **kw):
        calls.extend((a.dtype, b.dtype, a.numel())
                     for a, b in zip(a_list, b_list))
        return real(a_list, b_list, **kw)

    def spy_batch(acc, updates, weights, **kw):
        batches.append([(torch.float32, u.dtype, u.numel())
                        for u in updates[0]] * len(updates))
        return real_batch(acc, updates, weights, **kw)

    monkeypatch.setattr(ops, "pair_fuse_many", spy)
    monkeypatch.setattr(ops, "batch_fold", spy_batch)
    spec = FLJobSpec(job_id="probe", model_arch=cfg.name,
                     model_bytes=M.n_params(cfg) * 2, rounds=1, lr=0.05,
                     batch_size=8,
                     parties={f"p{i}": PartySpec(f"p{i}") for i in range(2)})
    res = Platform().train(cfg, spec, device="cpu", n_sequences=16,
                           eval_sequences=4)
    n = M.n_params(cfg)
    dt = getattr(torch, dtype)
    sizes = [s.numel() for s in tree_leaves(res.runtime.global_params)]
    leaves = [(torch.float32, dt, k) for k in sizes]
    assert calls[:10 * len(sizes)] == leaves * 10  # 3 warmup + 7 timed
    # the folds that followed: the drain's one batch of both updates, with
    # the same operands, and no pair_fuse
    assert calls[10 * len(sizes):] == []
    assert batches == [leaves * 2]
    assert res.runtime.t_pair0 > 0
    # t_upd still prices the bf16 bytes the parties ship
    assert res.runtime.spec.model_bytes == n * 2

    # the CPU cap: a probe of at most CPU_PROBE_CAP // 4 elements
    calls.clear()
    monkeypatch.setattr(job_mod, "CPU_PROBE_CAP", 4096)
    t = job_mod.probe_t_pair(sizes, dt, torch.device("cpu"))
    cut = [(torch.float32, dt, max(1, k * 1024 // n)) for k in sizes]
    assert calls == cut * 10 and t > 0
    assert sum(c[2] for c in cut) <= 1024 + len(sizes)
