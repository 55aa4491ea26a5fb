"""The configuration fields, blocks and router kinds that Nemotron-H
brought (B/C groups, a d_inner of heads x head_dim, conv biases, the
sigmoid router, the relu² experts, a held share of the experts, attention
without rotary embeddings, embeddings scaled by a flag) change nothing in
the configurations registered before them: each keeps its ``param_specs``
and its forward and gradient bits on a seeded batch, pinned here as
digests read before those fields existed. mamba2-130m (one B/C group) and
recurrentgemma-9b (the scaled embedding) are among them."""
import hashlib

import pytest
import torch

from repro_torch import configs, tree_leaves, tree_unflatten
from repro_torch.models import model as M

configs.load_all()

#: the reduced sizes of ``tests/_torch_families.py``
SMALL = dict(num_layers=2, d_model=64, vocab_size=128)
OVERRIDES = {
    "qwen1.5-4b": dict(num_kv_heads=4),
    "qwen2-moe-a2.7b": dict(num_experts=60, num_experts_per_tok=4,
                            num_shared_experts=4, d_ff=32),
    "llama4-scout-17b-a16e": dict(num_experts=16, num_experts_per_tok=1,
                                  num_shared_experts=1, d_ff=64),
    "mamba2-130m": dict(ssm_head_dim=32),
    "recurrentgemma-9b": dict(num_layers=5),
    "llama-3.2-vision-90b": dict(num_layers=5),
}
NAMES = configs.ARCH_IDS + ["example-100m"]


def spec_digest(name: str) -> str:
    """sha256 of every leaf's path, shape, axes, init, scale and dtype."""
    specs = M.param_specs(configs.get_config(name))
    rows = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            rows.append((path, node.shape, node.axes, node.init, node.scale,
                         node.dtype))

    walk(specs, ())
    return hashlib.sha256(repr(rows).encode()).hexdigest()


def run_digest(name: str, dtype: str) -> str:
    """sha256 of the logits, the aux loss, the loss and every gradient
    leaf of the reduced config in ``dtype`` on seeded weights and a
    seeded batch (B 2 x S 32), and of the logits of a prefill of its
    first 16 positions and one decode step after it, computed on one
    thread so that the sums run in one order."""
    cfg = configs.get_config(name).reduced(
        **{**SMALL, **OVERRIDES.get(name, {}), "dtype": dtype})
    gen = torch.Generator().manual_seed(1234)
    params = M.init(cfg, gen)
    shape = (2, 32, cfg.num_codebooks) if cfg.num_codebooks else (2, 32)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen)
             for k in ("tokens", "labels")}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(
            (2, cfg.num_image_tokens, cfg.d_model), generator=gen).to(
            params["embed"].dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        img = batch.get("image_embeds")
        with torch.no_grad():
            logits, _, aux = M.forward(cfg, params, batch["tokens"],
                                       image_embeds=img)
        pre, cache = M.prefill(cfg, params, batch["tokens"][:, :16],
                               image_embeds=img, capacity=32)
        dec, _ = M.decode_step(cfg, params, cache,
                               batch["tokens"][:, 16:17])
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for t in (logits, aux, loss.detach(), *grads, pre, dec):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


SPECS = {
    'recurrentgemma-9b':
        'c70eddf5bac75e2da680ca18c3373e32568532e487aa1b4ed0ee89caedbcfd57',
    'qwen1.5-4b':
        'd630818ec45820f59dbfe1bf7762ce6d044708a6b97e5795cd8417a18b4c21f2',
    'qwen3-0.6b':
        '171b4b6bae1abd936a683a71e03c9403055c3f11e33282720d730a23517cb1a0',
    'llama-3.2-vision-90b':
        '1d44ecff77c2cc2c7ef63d4f1b9269033ad4da84c5130977ee28d19b0fd07cfe',
    'mamba2-130m':
        '51247aa627ab5b077f900ec06a4f8ee75317e611bf9ef3adf77daf5f32ab2015',
    'musicgen-large':
        '0347400fdf6e7654fce0d55d0077febcd36c793111b56a3f1b06d8130d7d9f3e',
    'minitron-8b':
        '5dc315f7e88a85e8f6dfc3f507d22863f20abe47b808ee8da2f639a7cd81d29a',
    'llama4-scout-17b-a16e':
        'eb1e66eda66a8d22b9eecd3bec4eacf78cf347f5d7b6a9c9ddcffce2bba04d73',
    'qwen2.5-14b':
        '102e1215c4b4795f86734edbf181adf3f78061ef34f0a3a2bac89bc447eae895',
    'qwen2-moe-a2.7b':
        'bf10b9e54be0a726ed53591dc7254fb2071435dcfcf673afc4e6ea9f67004549',
    'example-100m':
        '3df5f75523e054b9f2f3c469ea3fde8940dae5a4a74630bdd55e872ee3699b60',
}
RUNS = {
    ('recurrentgemma-9b', 'float32'):
        'd8d09bb401298e83f569cdfcdc972d6fbbb31bd133c7de04d7cdd84ebab0c699',
    ('recurrentgemma-9b', 'bfloat16'):
        '0326e8d042683e5588413a287bbbbdf6a315c330dfaff327eb56cdcb05753625',
    ('qwen1.5-4b', 'float32'):
        'f64aa6cbe8ce9275a656d1e61694a42e0e3c7b59aeff6bb756478dffef7c6ca2',
    ('qwen1.5-4b', 'bfloat16'):
        'ddb05da0861a5773ec447d039d72d213778362daaabf725bb22d21bff1071d25',
    ('qwen3-0.6b', 'float32'):
        '814e531a063cf0ec1e734fc3ee4c0b7a475663de154cf08b962bda7b644df370',
    ('qwen3-0.6b', 'bfloat16'):
        '459628311eeff0d1254d331fd71fd86decaf33b6c9571ea00b086322e0c23caf',
    ('llama-3.2-vision-90b', 'float32'):
        '79e075425aa9c0555efd5547edb340cfd2781add52b330643104140d098267bc',
    ('llama-3.2-vision-90b', 'bfloat16'):
        '2f4188f07c8b0e7380c92f42f252578629030169aa16b820eba652d875556166',
    ('mamba2-130m', 'float32'):
        '9c538539c421f361ec795cd84bb4ce62c7fadf6f9591ca5067cb45e8267d2744',
    ('mamba2-130m', 'bfloat16'):
        'f69e04ac933c8e1549383efa948050c81685d6b54fa8d775e90b06d97298fd22',
    ('musicgen-large', 'float32'):
        'b15d9e0b926b17b17045db8a2d020b7b1e35ab2b21345b4b8501693e58d83cb4',
    ('musicgen-large', 'bfloat16'):
        '96a8fa2c9a28d9f1ea12dff15026146d9cb937e0e8c986a72fe44b462a5ca03b',
    ('minitron-8b', 'float32'):
        '20bdf80b79e0189932ed6a2216381ce67f82c4fd2a095d8699bb12df192ef310',
    ('minitron-8b', 'bfloat16'):
        '32502c73ddb65e7ef9fb719761505f7398113eb34fb208051247cf6d68a78fe1',
    ('llama4-scout-17b-a16e', 'float32'):
        '354d9f2ce84423a1e8f1fe967d4d5c4e3b6a723f8180d7120323cd1ad4b83196',
    ('llama4-scout-17b-a16e', 'bfloat16'):
        'a42c22687389793bf3a93abcffd237853e4676c2bc4599e3c30160c9cba27e39',
    ('qwen2.5-14b', 'float32'):
        '9f31b6e4636bd981abfd082334fc71b6ba5041b08eb3837321c55c8ad60701ba',
    ('qwen2.5-14b', 'bfloat16'):
        '8a262edbc4a2a7b993c7d3f43aa820b61aa15984d21636b9567d5cf721cd469e',
    ('qwen2-moe-a2.7b', 'float32'):
        'a789f159e66c21f31bd265dc5d71374d3dc608b54417a7fc109330991332ea50',
    ('qwen2-moe-a2.7b', 'bfloat16'):
        'e590c8209892d10c8d3ec492fb44b87ce27df23f415d33ed4bb50f989d3964b8',
    ('example-100m', 'float32'):
        '35875afa1e6c108fda00333dc284cdfb56039f5de07ea1b7d9a964be7b012ab2',
    ('example-100m', 'bfloat16'):
        '561e441ad1cd3d84fe97c0ad7ef5930d06f8abfe189ff4126c1ab6649b0e5f54',
}


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_are_unchanged(name):
    assert spec_digest(name) == SPECS[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_gradient_bits_are_unchanged(name, dtype):
    assert run_digest(name, dtype) == RUNS[name, dtype]
