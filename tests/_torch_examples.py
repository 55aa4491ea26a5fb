"""Shared by the example parity tests: the reference's example modules,
captured output, a spy on the reference's ``Platform.run``, and the
reference's ``Platform.train`` held against the port's."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.api import Platform as JPlatform
from repro.core.estimator import AggregationEstimator as JAggregationEstimator
from repro.core.jobspec import FLJobSpec as JFLJobSpec
from repro.core.jobspec import PartySpec as JPartySpec
from repro.models import model as JM
from repro_torch import tree_leaves

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn):
    """(printed text, return value) of ``fn()``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn()
    return out.getvalue(), ret


@pytest.fixture
def reference_runs(monkeypatch):
    """Every ``Platform.run`` result of the reference while the test runs."""
    seen = []
    run = JPlatform.run

    def spy(self, *a, **kw):
        seen.append(run(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(JPlatform, "run", spy)
    return seen


def _reference_train(jcfg, spec_kw, **train_kw):
    """The JAX package's Platform.train on ``spec_kw``, and its initial
    weights as numpy (the JAX runtime draws them from PRNGKey(seed=0))."""
    init = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    parties = {f"p{i}": JPartySpec(f"p{i}")
               for i in range(spec_kw.pop("n_parties"))}
    # the reference's t_pair probe is not what is compared: skip it
    res = JPlatform().train(
        jcfg, JFLJobSpec(parties=parties, **spec_kw), seed=0,
        heterogeneous=True, estimator=JAggregationEstimator(0.01),
        **train_kw)
    return res, init


def _assert_runs_agree(jres, res, tight_rounds):
    """Eval losses within rtol 1e-4 / atol 1e-5 and fused models (read back
    from each package's queue) within rtol 1e-4 and 1e-4 of the leaf's
    largest magnitude, for the first ``tight_rounds`` rounds; later eval
    losses within rtol 1e-2 (see the federated_100m test)."""
    assert [r.round_idx for r in res.records] == \
        [r.round_idx for r in jres.records]
    job = res.runtime.spec.job_id
    jfused = [m.value for m in
              jres.runtime.queue.topic(f"fused/{job}").poll("test")]
    fused = [m.value for m in
             res.runtime.queue.topic(f"fused/{job}").poll("test")]
    for r, (a, b) in enumerate(zip(jres.records, res.records, strict=True)):
        tight = r < tight_rounds
        np.testing.assert_allclose(b.global_loss, a.global_loss,
                                   rtol=1e-4 if tight else 1e-2, atol=1e-5)
        if tight:
            for x, y in zip(jax.tree.leaves(jfused[r]),
                            tree_leaves(fused[r]), strict=True):
                x = np.asarray(x)
                np.testing.assert_allclose(y.numpy(), x, rtol=1e-4,
                                           atol=1e-4 * np.abs(x).max())
    assert res.metrics.rounds_done == jres.metrics.rounds_done
    assert res.metrics.strategy == jres.metrics.strategy
    assert res.records[-1].global_loss < res.records[0].global_loss
