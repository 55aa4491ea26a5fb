"""Milliseconds a folded update: a span in the benchmark's code around
``AggregationExecutor.drain`` of each window round, closed by a
synchronise (traced run only), over the updates it folded."""


def read(rec):
    spans = [s["drain_s"] for s in rec["steps"] if s.get("drain_s")]
    if not spans or rec["traffic"]["kind"] != "agg_backlog":
        return None
    folded = sum(s["units"] for s in rec["steps"] if s.get("drain_s"))
    return 1e3 * sum(spans) / folded
