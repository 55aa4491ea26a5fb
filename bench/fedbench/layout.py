"""The parameter leaves of a configuration: key path, shape and
initialiser, in the program's leaf order (keys sorted at every level), so
that a tree the benchmark makes can be handed to the program as it is.

The standard deviations are the fan-in rule the program's initialiser
uses (1 / sqrt of the second-to-last dim, times a scale), frozen here;
Mamba-2's ``dt_bias`` takes the published initialisation instead of the
program's zeros (``weights.make_model``)."""
from __future__ import annotations

import math
from typing import Dict, List


def _normal(shape, scale=1.0):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return {"shape": list(shape), "init": "normal",
            "std": scale / math.sqrt(max(fan_in, 1))}


def _const(shape, init):
    return {"shape": list(shape), "init": init}


def _attn_block(run: Dict, n: int) -> Dict:
    d, h, kv, hd = (run["d_model"], run["num_heads"], run["num_kv_heads"],
                    run["head_dim"])
    ff = run["d_ff"]
    return {
        "attn": {
            "k_norm": _const((n, hd), "ones"),
            "q_norm": _const((n, hd), "ones"),
            "wk": _normal((n, d, kv, hd)),
            "wo": _normal((n, h, hd, d)),
            "wq": _normal((n, d, h, hd)),
            "wv": _normal((n, d, kv, hd)),
        },
        "ffn": {
            "w_down": _normal((n, ff, d)),
            "w_gate": _normal((n, d, ff)),
            "w_up": _normal((n, d, ff)),
        },
        "ln1": _const((n, d), "ones"),
        "ln2": _const((n, d), "ones"),
    }


def _ssm_block(run: Dict, n: int) -> Dict:
    d = run["d_model"]
    din = run["ssm_expand"] * d
    st, h, k = run["ssm_state"], run["ssm_heads"], run["conv_kernel"]
    if din != h * run["ssm_head_dim"]:
        raise ValueError("d_inner must equal ssm_heads x ssm_head_dim")
    return {
        "ln1": _const((n, d), "ones"),
        "ssm": {
            "A_log": _const((n, h), "zeros"),
            "D": _const((n, h), "ones"),
            "conv_B": _normal((n, k, st), 0.5),
            "conv_C": _normal((n, k, st), 0.5),
            "conv_x": _normal((n, k, din), 0.5),
            "dt_bias": _const((n, h), "dt_bias"),
            "norm": _const((n, din), "ones"),
            "w_B": _normal((n, d, st)),
            "w_C": _normal((n, d, st)),
            "w_dt": _normal((n, d, h)),
            "w_out": _normal((n, din, d)),
            "w_x": _normal((n, d, din)),
            "w_z": _normal((n, d, din)),
        },
    }


BLOCKS = {"attn": _attn_block, "ssm": _ssm_block}


def leaves(run: Dict) -> List[Dict]:
    """[{"path", "shape", "init"[, "std"]}] in the program's leaf order."""
    (btype,) = set(run["block_pattern"])
    d, v = run["d_model"], run["vocab_size"]
    tree = {
        "embed": _normal((v, d)),
        "final_norm": _const((d,), "ones"),
        "lm_head": _normal((d, v)),
        "stage0": {f"b0_{btype}": BLOCKS[btype](run, run["num_layers"])},
    }
    out: List[Dict] = []

    def walk(node, path):
        if "shape" in node:
            out.append({"path": path, **node})
            return
        for key in sorted(node):
            walk(node[key], path + [key])

    walk(tree, [])
    return out


def with_leaves(config: Dict) -> Dict:
    """``config`` with its ``leaves`` worked out from its ``run`` block."""
    return {**config, "leaves": leaves(config["run"])}
