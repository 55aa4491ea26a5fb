"""``plain(x)``: a result of either package as nested dicts, lists and
numbers, so that the reference's and the port's results compare with
``==``. Dataclasses become dicts of their fields, numpy values Python
values, and NaN the string "nan" (NaN != NaN would fail an exact match)."""
import dataclasses
import math

import numpy as np


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x
