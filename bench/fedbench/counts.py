"""The yardstick's arithmetic: the card's peak bandwidth, the fold's byte
formula and the least a round of FedAvg must move."""
from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s
PEAK_HBM_BYTES_S = 3.35e12
BF16, F32 = 2, 4


def fold_bytes(n_elems: int, update_itemsize: int = BF16) -> int:
    """One streaming fold acc' = acc + w * u over ``n_elems`` elements: the
    fp32 accumulator read, the update read in its dtype, fp32 written."""
    return n_elems * (F32 + update_itemsize + F32)


def round_min_bytes(n_elems: int, k: int, update_itemsize: int = BF16,
                    model_itemsize: int = BF16) -> int:
    """What a round of FedAvg over ``k`` updates must move at the least:
    every update read once and the new global model written once."""
    return n_elems * (k * update_itemsize + model_itemsize)


def count_elems(leaves) -> int:
    return int(sum(math.prod(leaf["shape"]) for leaf in leaves))
