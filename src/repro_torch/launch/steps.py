"""Step functions and their abstract inputs for every (architecture x input
shape) combination, on one device: the trainer and the server call them.

``build`` returns the step, its arguments as tensors on the "meta" device
(shapes and dtypes, no storage) and the indices of the arguments the step
consumes. The reference's ``build`` also returns a sharding for every
argument over a device mesh; the port has no mesh yet, so there are none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch import Pytree, tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
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
# abstract inputs
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
    if cfg.num_codebooks:
        tok_spec = TensorSpec((shape.global_batch, 1, cfg.num_codebooks),
                              ("batch", None, None), dtype="int32")
    else:
        tok_spec = TensorSpec((shape.global_batch, 1), ("batch", None),
                              dtype="int32")
    args = (p_abs, abstract_params(cspecs), abstract_params(tok_spec))
    return make_decode_step(cfg), args, (1,)
