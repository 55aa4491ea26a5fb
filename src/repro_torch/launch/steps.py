"""Step functions, their abstract inputs and their shardings for every
(architecture x input shape) combination: the trainer and the server call
them.

``build`` returns the step, its arguments as tensors on the "meta" device
(shapes and dtypes, no storage) and the indices of the arguments the step
consumes. ``shardings`` gives what the reference's ``build`` returns
beside them: a ``NamedSharding`` for every argument over a mesh (a
``DeviceMesh`` or a mapping of axis sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch import Pytree, tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.models import model as M
from repro_torch.models.sharding_ctx import as_layout
from repro_torch.models.spec import TensorSpec, abstract_params
from repro_torch.optim import adamw, clip_by_global_norm


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, optimizer=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    autograd through ``loss_fn``, the gradients clipped to global norm 1,
    then the optimizer (AdamW at 3e-4 unless one is given)."""
    opt = optimizer or adamw(3e-4)

    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        # on DTensors, each gradient laid out as its parameter once (a
        # reduce-scatter or all-reduce of a partial sum), not again at
        # every use in the clip and the update
        grads = tree_map(as_layout, grads, params)
        grads = clip_by_global_norm(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    if cfg.num_image_tokens:
        def step(params, tokens, image_embeds):
            return M.prefill(cfg, params, tokens, image_embeds=image_embeds)
    else:
        def step(params, tokens):
            return M.prefill(cfg, params, tokens)
    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens)

    return step


# --------------------------------------------------------------------------
# abstract inputs and shardings
# --------------------------------------------------------------------------
def opt_state_specs(param_specs_tree: Pytree) -> Pytree:
    """AdamW state spec tree mirroring the params (fp32 moments)."""
    f32 = lambda s: dataclasses.replace(s, dtype="float32")
    return {
        "step": TensorSpec((), (), dtype="int32"),
        "m": tree_map(f32, param_specs_tree),
        "v": tree_map(f32, param_specs_tree),
    }


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    tok_axes = ("batch", "seq", None) if cfg.num_codebooks else ("batch", "seq")
    out = {
        "tokens": TensorSpec(tok_shape, tok_axes, dtype="int32"),
        "labels": TensorSpec(tok_shape, tok_axes, dtype="int32"),
    }
    if cfg.num_image_tokens:
        out["image_embeds"] = TensorSpec(
            (b, cfg.num_image_tokens, cfg.d_model), ("batch", None, None),
            dtype=cfg.dtype,
        )
    return out


def decode_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.name == "long_500k" and cfg.long_context == "swa":
        return cfg.swa_window
    if shape.name == "long_500k":  # native sub-quadratic
        return cfg.sliding_window or 2048  # lattn window; ssm ignores capacity
    return shape.seq_len


# decode caches: prefer sharding KV heads over the model axis (GQA archs with
# kv < 16 fall back to sharding the cache sequence dim instead — distributed
# softmax — so a 32k x 128 cache never sits replicated on one device)
CACHE_RULES = dict(
    shd.ACT_RULES,
    kv_heads=[("model",)],
    cache_seq=[("model",)],
)


def _tok_spec(cfg: ModelConfig, shape: InputShape) -> TensorSpec:
    """The decode step's (B, 1) tokens, (B, 1, K) with K codebooks."""
    if cfg.num_codebooks:
        return TensorSpec((shape.global_batch, 1, cfg.num_codebooks),
                          ("batch", None, None), dtype="int32")
    return TensorSpec((shape.global_batch, 1), ("batch", None), dtype="int32")


def shardings(cfg: ModelConfig, shape: InputShape, mesh,
              profile: str = "baseline"):
    """The reference's ``in_shardings`` of ``build``'s arguments.

    profile: "baseline" = the paper-faithful initial sharding;
             "optimized" = beyond-paper perf profile (§Perf): pure-TP params
             for decode (no per-step FSDP all-gathers)."""
    if profile not in ("baseline", "optimized"):
        raise ValueError(f"unknown profile {profile!r}")
    pspecs = M.param_specs(cfg)
    prules = shd.PARAM_RULES
    if profile == "optimized" and shape.kind == "decode":
        prules = shd.DECODE_PARAM_RULES
    p_sh = shd.tree_shardings(pspecs, mesh, prules)

    def act_shard(spec_tree):
        return shd.tree_shardings(spec_tree, mesh, CACHE_RULES)

    if shape.kind == "train":
        return (p_sh,
                {"step": shd.NamedSharding(mesh, ()),
                 "m": shd.like_tree(p_sh, pspecs),
                 "v": shd.like_tree(p_sh, pspecs)},
                act_shard(batch_specs(cfg, shape)))
    if shape.kind == "prefill":
        bspecs = batch_specs(cfg, shape)
        out = [p_sh, act_shard(bspecs["tokens"])]
        if cfg.num_image_tokens:
            out.append(act_shard(bspecs["image_embeds"]))
        return tuple(out)
    cspecs = M.cache_specs(cfg, shape.global_batch,
                           decode_capacity(cfg, shape))
    return p_sh, act_shard(cspecs), act_shard(_tok_spec(cfg, shape))


def build(cfg: ModelConfig, shape: InputShape):
    """Returns (fn, args_abstract, donate_argnums): the step for the
    shape's kind, its arguments on the "meta" device, and the arguments it
    consumes (the train step's params and optimizer state, the decode
    step's cache)."""
    pspecs = M.param_specs(cfg)
    p_abs = abstract_params(pspecs)

    if shape.kind == "train":
        args = (p_abs, abstract_params(opt_state_specs(pspecs)),
                abstract_params(batch_specs(cfg, shape)))
        return make_train_step(cfg), args, (0, 1)

    if shape.kind == "prefill":
        bspecs = batch_specs(cfg, shape)
        args = [p_abs, abstract_params(bspecs["tokens"])]
        if cfg.num_image_tokens:
            args.append(abstract_params(bspecs["image_embeds"]))
        return make_prefill_step(cfg), tuple(args), ()

    # decode
    cap = decode_capacity(cfg, shape)
    cspecs = M.cache_specs(cfg, shape.global_batch, cap)
    args = (p_abs, abstract_params(cspecs),
            abstract_params(_tok_spec(cfg, shape)))
    return make_decode_step(cfg), args, (1,)
