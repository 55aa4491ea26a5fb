"""pair_fuse's share of its bandwidth roofline in the traced round: the
bytes of the round's pair_fuse folds (``fedbench/counts.py``
``fold_bytes``: the fp32 accumulator read, the update read in its dtype,
fp32 written) over 3.35 TB/s, over the device time the trace gives every
pair_fuse launch of the round.

It counts folds, not launches: a round's first update starts the
accumulator with a cast, and each later one is one fold, so the folds are
the traced round's updates less one. A fold may take one launch or
several (a table of up to 64 leaves a dtype pair), and the reading is
the same whichever. Nothing to read when the trace holds no pair_fuse
launch, or not the launches the kernel's own counter made."""
from fedbench import counts as _counts


def read(rec):
    tr = rec.get("trace")
    if not tr or rec["traffic"]["kind"] != "agg_backlog":
        return None
    launches, seconds = 0, 0.0
    for name, (n, s) in tr["kernels"].items():
        if "pair_fuse" in name:
            launches += n
            seconds += s
    step = rec["traced_step"]
    folds = step["units"] - 1
    if launches == 0 or seconds <= 0 or folds <= 0 \
            or launches != step["pair_fuse_launches"]:
        return None
    return 100.0 * folds * rec["fold_bytes"] / _counts.PEAK_HBM_BYTES_S / seconds
