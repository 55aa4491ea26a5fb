"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  r/i = sigmoid(linear(u))

Training/prefill evaluates the diagonal linear recurrence with a log-depth
parallel scan written in tensor ops (``_linear_scan``); decode is the O(1)
step. A given cache is written in place (``copy_``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import causal_conv1d, conv1d_step
from repro_torch.models.spec import TensorSpec

Cache = Dict[str, torch.Tensor]


def rglru_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    d, r = cfg.d_model, cfg.rnn_width
    k = cfg.conv_kernel
    return {
        "w_y": TensorSpec((d, r), ("d_model", "d_inner")),   # gate branch
        "w_x": TensorSpec((d, r), ("d_model", "d_inner")),   # recurrent branch
        "conv": TensorSpec((k, r), (None, "d_inner"), scale=0.5),
        "w_a": TensorSpec((r, r), ("d_inner", None), scale=0.5),
        "w_i": TensorSpec((r, r), ("d_inner", None), scale=0.5),
        "Lambda": TensorSpec((r,), (None,), init="rglru_lambda"),
        "w_out": TensorSpec((r, d), ("d_inner", "d_model")),
    }


def rglru_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    r, k = cfg.rnn_width, cfg.conv_kernel
    return {
        "h": TensorSpec((batch, r), ("batch", "d_inner"), init="zeros",
                        dtype="float32"),
        "conv": TensorSpec((batch, k - 1, r), ("batch", None, "d_inner"),
                           init="zeros"),
    }


def _gates(cfg: ModelConfig, prm, u: torch.Tensor):
    """u: (..., r) -> (a, beta*i) in fp32."""
    r_gate = torch.sigmoid((u @ prm["w_a"]).to(torch.float32))
    i_gate = torch.sigmoid((u @ prm["w_i"]).to(torch.float32))
    log_a = -cfg.rglru_c * F.softplus(prm["Lambda"].to(torch.float32)) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0))
    return a, beta * i_gate


def _linear_scan(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of (a, b) along dim 1 under the combine (a1*a2,
    a2*b1 + b2): its b is h_t = a_t * h_{t-1} + b_t from h_{-1} = 0.

    The odd-even recursion of ``jax.lax.associative_scan`` (log2(S) levels,
    O(S) work), which the reference calls: neighbours are combined in
    pairs, the pairs scanned, and each even position then combined with the
    odd prefix before it."""
    s = a.shape[1]
    if s < 2:
        return a, b
    odd_a, odd_b = _linear_scan(a[:, 0:-1:2] * a[:, 1::2],
                                a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    if s % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    even_a = torch.cat([a[:, :1], pa * a[:, 2::2]], dim=1)
    even_b = torch.cat([b[:, :1], a[:, 2::2] * pb + b[:, 2::2]], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (len(even) is
    len(odd) or one more)."""
    n_odd = odd.shape[1]
    both = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n_odd:]], dim=1)


def rglru_apply(
    cfg: ModelConfig,
    prm: Dict[str, torch.Tensor],
    xin: torch.Tensor,  # (B, S, d)
    *,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Training when cache is None; with a cache, S > 1 is a prefill from
    the cache's state (the last state and the last K-1 raw inputs are
    written into it) and S == 1 a decode step. Returns (output, the cache
    written in place)."""
    f32 = torch.float32
    b, s, _ = xin.shape
    y_gate = F.gelu(xin @ prm["w_y"], approximate="tanh")  # jax.nn.gelu's
    u_raw = xin @ prm["w_x"]

    if cache is not None and s == 1:  # decode
        u, conv_c = conv1d_step(u_raw[:, 0], cache["conv"], prm["conv"])
        a, bi = _gates(cfg, prm, u)
        h = a * cache["h"] + bi * u.to(f32)
        y = h[:, None, :].to(xin.dtype)
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_c)
    else:
        u = causal_conv1d(u_raw, prm["conv"])
        a, bi = _gates(cfg, prm, u)
        bx = bi * u.to(f32)  # (B,S,r)
        if cache is not None:
            # fold the incoming state into the first element
            bx = torch.cat([bx[:, :1] + a[:, :1] * cache["h"][:, None],
                            bx[:, 1:]], dim=1)
        _, h = _linear_scan(a, bx)
        y = h.to(xin.dtype)
        if cache is not None:
            k = cfg.conv_kernel
            cache["h"].copy_(h[:, -1, :])
            cache["conv"].copy_(u_raw[:, s - (k - 1):, :])

    return (y * y_gate) @ prm["w_out"], cache
