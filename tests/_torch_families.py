"""Shared by the family parity tests: the reduced configs of both packages,
the reference's initial weights with the q/k/v biases redrawn, and
numpy-seeded batches (codebook tokens and image embeddings included)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core.estimator import AggregationEstimator as JAggregationEstimator
from repro.core.jobspec import FLJobSpec as JFLJobSpec
from repro.core.jobspec import PartySpec as JPartySpec
from repro.fl.job import FLJobRuntime as JFLJobRuntime
from repro.fl.party import Party as JParty
from repro.models import model as JM
from repro_torch.models import model as M
from repro_torch import configs, interop, tree_leaves, tree_unflatten
from repro_torch.api import Platform
from repro_torch.core.jobspec import FLJobSpec, PartySpec
from repro_torch.fl.party import Party

jconfigs.load_all()
configs.load_all()

SMALL = dict(num_layers=2, d_model=64, vocab_size=128)
OVERRIDES = {
    "qwen1.5-4b": dict(num_kv_heads=4),  # MHA, as published
    "qwen2.5-14b": {},
    "minitron-8b": {},
    "qwen2-moe-a2.7b": dict(num_experts=60, num_experts_per_tok=4,
                            num_shared_experts=4, d_ff=32),
    "llama4-scout-17b-a16e": dict(num_experts=16, num_experts_per_tok=1,
                                  num_shared_experts=1, d_ff=64),
    # d_inner (2 x 64) = 4 heads x 32: reduced() sizes the heads for its
    # own d_model of 256
    "mamba2-130m": dict(ssm_head_dim=32),
    # 5 layers: one (rglru, rglru, lattn) repeat and the (rglru, rglru)
    # remainder stage
    "recurrentgemma-9b": dict(num_layers=5),
    "musicgen-large": {},
    # 5 layers: one (attn x4, xattn) repeat
    "llama-3.2-vision-90b": dict(num_layers=5),
}
BIAS = ["qwen1.5-4b", "qwen2.5-14b"]
MOE = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]


def _cfgs(name, dtype="float32", **over):
    kw = {**SMALL, **OVERRIDES[name], "dtype": dtype, **over}
    return (jconfigs.get_config(name).reduced(**kw),
            configs.get_config(name).reduced(**kw))


def _params(jcfg, seed=0, condition=False):
    """The reference's init with every q/k/v bias drawn at random: (numpy
    tree, jax tree, torch tree). With ``condition``, the attention
    projections are also rescaled to a fan-in over their input axes, as
    ``chip_smoke.conditioned`` does: from the init alone, training these
    configs without qk_norm is chaotic (``test_torch_families_job.py``)."""
    rng = np.random.default_rng(100 + seed)

    def redraw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith(("['bq']", "['bk']", "['bv']")):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if condition and key.endswith(("['wq']", "['wk']", "['wv']")):
            return (a * np.sqrt(a.shape[-2] / a.shape[-3])).astype(a.dtype)
        if condition and key.endswith("['wo']"):
            return (a / np.sqrt(a.shape[-3])).astype(a.dtype)
        return a

    init = JM.init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map_with_path(
        redraw, jax.tree.map(np.asarray, init))
    return tree, jax.tree.map(jnp.asarray, tree), interop.to_torch(tree, "cpu")


def _batch(seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    data = {k: rng.integers(0, vocab, (4, 32)).astype(np.int32)
            for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v).long() for k, v in data.items()})


def _batch_for(cfg, seed=0, b=4, s=32):
    """(jax batch, torch batch) for ``cfg``: tokens and labels, (b, s) or
    (b, s, K) with K codebooks, and N(0, 1) image embeddings (b, P, d) in
    the config's dtype for a config with image tokens."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    data = {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in data.items()}
    if cfg.num_image_tokens:
        img = rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model))
        img = img.astype(np.float32)
        jb["image_embeds"] = jnp.asarray(img).astype(cfg.dtype)
        tb["image_embeds"] = interop.to_torch(np.asarray(jb["image_embeds"]),
                                              "cpu")
    return jb, tb


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _grads_port(cfg, tp, tb, key="loss"):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, metrics = M.loss_fn(cfg, tree_unflatten(tp, leaves), tb)
    out = loss if key == "loss" else metrics[key]
    return out.detach(), torch.autograd.grad(out, leaves, allow_unused=True)


def check_runtime_matches_reference(name):
    """The runtime of ``test_torch_families_job.py`` (whose docstring gives
    the tolerances) for config ``name``."""
    jcfg, cfg = _cfgs(name)
    kw = dict(n_sequences=48, eval_sequences=16, seed=0)

    def spec(cls, pcls):
        return cls(job_id="fam", model_arch=cfg.name,
                   model_bytes=M.n_params(cfg) * 4,
                   aggregation_algorithm="fedavg", rounds=2, lr=0.05,
                   batch_size=8,
                   parties={f"p{i}": pcls(f"p{i}") for i in range(3)})

    jrt = JFLJobRuntime(jcfg, spec(JFLJobSpec, JPartySpec), interpret=True,
                        estimator=JAggregationEstimator(0.01), **kw)
    tree, jrt.global_params, init = _params(jcfg, condition=True)
    ref = [(jrt.run_round(r).global_loss, jrt.global_params)
           for r in range(2)]
    res = Platform().train(cfg, spec(FLJobSpec, PartySpec), device="cpu",
                           initial_params=init, **kw)
    fused = [m.value for m in res.runtime.queue.topic("fused/fam").poll("t")]
    assert len(fused) == 2
    for r, ((jloss, jparams), rec, params) in enumerate(
            zip(ref, res.records, fused)):
        np.testing.assert_allclose(rec.global_loss, jloss, rtol=1e-4,
                                   atol=1e-5)
        for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params),
                        strict=True):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
    assert res.records[-1].global_loss < float(JM.loss_fn(
        jcfg, jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in jrt.eval_data.items()
         if k != "domains"})[0])


def check_party_round_matches_reference(name):
    """One party's local round of config ``name`` against the reference's
    (``test_torch_families_job.py`` gives the tolerances)."""
    jcfg, cfg = _cfgs(name)
    _, jp, tp = _params(jcfg, seed=5, condition=True)
    rng = np.random.default_rng(5)
    data = {k: rng.integers(0, 128, (16, 64)).astype(np.int32)
            for k in ("tokens", "labels")}
    kw = dict(batch_size=8, lr=0.05, seed=0)
    want = JParty("p", jcfg, data, **kw).local_round(jp)
    got = Party("p", cfg, data, device="cpu", **kw).local_round(tp)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(want.update), tree_leaves(got.update),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
