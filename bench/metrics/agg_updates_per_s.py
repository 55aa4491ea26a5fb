"""Updates fused a second: every update folded in the window over the
window's length (host clock; the window ends at a round's synchronise)."""


def read(rec):
    if rec["traffic"]["kind"] != "agg_backlog":
        return None
    return sum(s["units"] for s in rec["steps"]) / rec["window_s"]
