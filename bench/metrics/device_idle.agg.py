"""The share of the traced step (one whole round after the window, under
``torch.profiler``) in which no kernel, copy or fill ran on the card."""
from fedbench.devtrace import idle_share


def read(rec):
    if rec["traffic"]["kind"] != "agg_backlog":
        return None
    return idle_share(rec.get("trace"))
