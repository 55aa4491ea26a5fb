"""The four families this slice ports through the port's user-facing
surfaces on the CPU: ``scripts/torch_smoke_models.py`` (the twin of
``scripts/smoke_models.py``), ``launch.serve.main`` and ``launch.train.main``
at ``--reduced``, and greedy decoding through ``serve.generate`` against the
reference's serve loop (the same tokens, from ``_params(condition=True)``
weights: greedy picks from a chaotic forward could flip on a rounding)."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.launch import serve, train

from _torch_families import _batch_for, _cfgs, _params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["recurrentgemma-9b", "llama-3.2-vision-90b", "mamba2-130m",
            "musicgen-large"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_smoke_models", ROOT / "scripts" / "torch_smoke_models.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_script_runs_the_new_families(capsys):
    assert _script().main([*FAMILIES, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == FAMILIES
    assert all(line.endswith(" OK") for line in lines)
    assert "logits=(2, 32, 4, 512) decode=(2, 1, 4, 512)" in lines[3]


@pytest.mark.parametrize("name", FAMILIES)
def test_launchers_run_reduced_on_the_cpu(name, capsys):
    assert serve.main(["--arch", name, "--reduced", "--batch", "2",
                       "--prompt-len", "16", "--tokens", "3",
                       "--device", "cpu"]) == 0
    assert train.main(["--arch", name, "--reduced", "--steps", "2",
                       "--seq-len", "32", "--batch", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    shape = "(2, 3, 4)" if name == "musicgen-large" else "(2, 3)"
    assert f"generated {shape} tokens" in out and out.count("ok\n") == 2


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_decode_yields_the_reference_tokens(name):
    """The reference's serve loop (prefill with the image embeddings and
    capacity prompt + tokens, then greedy decode steps) and
    ``serve.generate`` from the same weights and prompt pick the same
    tokens."""
    jcfg, cfg = _cfgs(name)
    _, jp, tp = _params(jcfg, condition=True)
    jb, tb = _batch_for(cfg, seed=7, b=3, s=16)
    n_tokens = 8
    logits, cache = JM.prefill(jcfg, jp, jb["tokens"], capacity=16 + n_tokens,
                               image_embeds=jb.get("image_embeds"))
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [nxt]
    jdecode = jax.jit(functools.partial(JM.decode_step, jcfg))  # as serve.py
    for _ in range(n_tokens - 1):
        logits, cache = jdecode(jp, cache, nxt)
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(nxt)
    out = serve.generate(cfg, tp, tb["tokens"].to(torch.int32), n_tokens - 1,
                         16 + n_tokens, image_embeds=tb.get("image_embeds"))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    assert out.finite and int(out.cache["t"]) == 16 + n_tokens - 1
