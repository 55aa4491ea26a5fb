"""The parameter leaves of a configuration: key path, shape, initialiser
and standard deviation, in the order the benchmark hands its trees to the
program.

A configuration file may list its own leaves under ``leaves``, each with
a ``path`` (a list of keys), a ``shape``, an ``init`` of
``weights.make_model``'s and, for ``normal`` only, an optional ``scale``
(default 1). The list is then taken as it stands, in its order, so a
configuration of any block pattern the program builds is one data file.
A file without ``leaves`` has them derived from its ``run`` block, for
one block type of ``BLOCKS``, in the program's leaf order (keys sorted at
every level). Both routes pass through ``resolve``, which checks the list
and gives every normal leaf the std of the fan-in rule the program's
initialiser uses (scale / sqrt of the second-to-last dim), so the two
cannot disagree on it. Mamba-2's ``dt_bias`` takes the published
initialisation instead of the program's zeros (``weights.make_model``)."""
from __future__ import annotations

import math
from typing import Dict, List

#: the initialisers of ``weights.make_model``
INITS = ("normal", "ones", "zeros", "dt_bias")
_KEYS = {"path", "shape", "init", "scale"}


def _normal(shape, scale=1.0):
    return {"shape": list(shape), "init": "normal", "scale": scale}


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


def derive(run: Dict) -> List[Dict]:
    """The leaves of ``run``'s one block type, as a file would list them
    ([{"path", "shape", "init"[, "scale"]}]), in the program's order."""
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


def _std(shape: List[int], scale: float) -> float:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return scale / math.sqrt(max(fan_in, 1))


def resolve(listed: List[Dict]) -> List[Dict]:
    """[{"path", "shape", "init"[, "std"]}] of a listed layout, in its
    order; raises ``ValueError`` naming the path of a leaf that is
    malformed, repeated, or a prefix of another leaf's path."""
    if not isinstance(listed, list) or not listed:
        raise ValueError("leaves: a non-empty list of leaves is needed")
    out = []
    for entry in listed:
        path = entry.get("path") if isinstance(entry, dict) else None
        if not (isinstance(path, list) and path
                and all(isinstance(k, str) and k for k in path)):
            raise ValueError(f"leaf path {path!r}: not a list of keys")
        extra = sorted(set(entry) - _KEYS)
        if extra:
            raise ValueError(f"leaf path {path}: unknown keys {extra}")
        shape, init = entry.get("shape"), entry.get("init")
        if not (isinstance(shape, list) and shape and all(
                type(n) is int and n > 0 for n in shape)):
            raise ValueError(f"leaf path {path}: shape {shape!r} is not "
                             f"a list of positive integers")
        if init not in INITS:
            raise ValueError(f"leaf path {path}: unknown init {init!r}")
        leaf = {"path": list(path), "shape": list(shape), "init": init}
        scale = entry.get("scale", 1.0)
        if init != "normal" and "scale" in entry:
            raise ValueError(f"leaf path {path}: a scale is for normal "
                             f"leaves only")
        if isinstance(scale, bool) or not isinstance(scale, (int, float)) \
                or not 0 < scale < math.inf:
            raise ValueError(f"leaf path {path}: scale {scale!r} is not a "
                             f"positive number")
        if init == "normal":
            leaf["std"] = _std(shape, scale)
        out.append(leaf)
    # a path's descendants sort right after it, so neighbours suffice
    paths = sorted(tuple(leaf["path"]) for leaf in out)
    for a, b in zip(paths, paths[1:]):
        if a == b:
            raise ValueError(f"leaf path {list(a)} is repeated")
        if b[:len(a)] == a:
            raise ValueError(f"leaf path {list(a)} is a prefix of "
                             f"{list(b)}")
    return out


def with_leaves(config: Dict) -> Dict:
    """``config`` with its ``leaves`` resolved: the file's own list where
    it has a ``leaves`` key, else those derived from its ``run`` block."""
    listed = config["leaves"] if "leaves" in config else derive(
        config["run"])
    return {**config, "leaves": resolve(listed)}
