"""The whole aggregation round's share of the card's peak: the least the
round must move (every update read once in its dtype, the new global
model written once; its FLOPs are negligible) over 3.35 TB/s, times the
window's rounds, over the window's length. It bounds any fold, streaming
or batched."""
from fedbench import counts as _counts


def read(rec):
    if rec["traffic"]["kind"] != "agg_backlog":
        return None
    rounds = len(rec["steps"])
    return 100.0 * (rec["round_min_bytes"] * rounds / _counts.PEAK_HBM_BYTES_S
            / rec["window_s"])
