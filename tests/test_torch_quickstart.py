"""The port's ``quickstart`` example against the reference's
(``examples/quickstart.py``) on the CPU, held as ``test_torch_examples.py``
says: ``simulate`` equal (``==``) in its printed report and its metrics;
``train`` at the quickstart's own tiny qwen3 in fp32 against the JAX
package's ``Platform.train`` from the same weights."""
import torch

from repro import configs as jconfigs
from repro_torch import configs, interop
from repro_torch.examples import quickstart
from repro_torch.models import model as M
from _torch_examples import (  # noqa: F401 (reference_runs is a fixture)
    _assert_runs_agree, _reference, _reference_train, _run, reference_runs)
from _torch_parity import plain

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

jconfigs.load_all()
configs.load_all()


def test_quickstart_simulate_equals_reference(reference_runs):
    want_text, _ = _run(_reference("quickstart").simulate)
    text, results = _run(quickstart.simulate)
    assert text == want_text
    assert plain(list(results.values())) == [
        plain(m["sim"]) for m in reference_runs]


def test_quickstart_train_matches_reference():
    """The quickstart's own tiny qwen3 (2 layers, d_model 128, vocab 256)
    in fp32, 5 parties, 2 rounds of 80 sequences."""
    kw = dict(num_layers=2, d_model=128, vocab_size=256, dtype="float32")
    jcfg = jconfigs.get_config("qwen3-0.6b").reduced(**kw)
    cfg = configs.get_config("qwen3-0.6b").reduced(**kw)
    jres, init = _reference_train(
        jcfg, dict(job_id="quickstart", model_arch=cfg.name,
                   model_bytes=M.n_params(cfg) * 4, rounds=2, lr=0.05,
                   batch_size=8, aggregation_algorithm="fedavg",
                   n_parties=5),
        n_sequences=80)
    text, (res, ao) = _run(lambda: quickstart.train(
        cfg, rounds=2, n_sequences=80, device="cpu",
        initial_params=interop.to_torch(init, "cpu")))
    _assert_runs_agree(jres, res, tight_rounds=2)
    assert ao.strategy == "eager_ao" and ao.rounds_done == 2
    assert "--- summary ---" in text and "always-on" in text
