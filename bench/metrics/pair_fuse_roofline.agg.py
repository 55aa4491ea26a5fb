"""pair_fuse's share of its bandwidth roofline in the traced round: the
bytes of its launches (``fedbench/counts.py`` ``fold_bytes``: the fp32
accumulator read, the update read in its dtype, fp32 written; one launch
a leaf a fold) over 3.35 TB/s, over the device time the trace gives those
launches. Nothing to read when the trace holds no pair_fuse launch, or
not the launches the kernel's own counter made."""
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
    counted = rec["traced_step"]["pair_fuse_launches"]
    if launches == 0 or seconds <= 0 or launches != counted \
            or launches % rec["n_leaves"]:
        return None
    folds = launches // rec["n_leaves"]
    return 100.0 * folds * rec["fold_bytes"] / _counts.PEAK_HBM_BYTES_S / seconds
