"""GiB the card holds more after each round: the least-squares slope of
``torch.cuda.memory_allocated()`` read after each window round's
publish and synchronise, over the round's index."""

GIB = 2 ** 30


def read(rec):
    if rec["traffic"]["kind"] != "agg_backlog":
        return None
    ys = [s["mem_bytes"] / GIB for s in rec["steps"]]
    n = len(ys)
    if n < 2:
        return None
    xm, ym = (n - 1) / 2, sum(ys) / n
    num = sum((i - xm) * (y - ym) for i, y in enumerate(ys))
    den = sum((i - xm) ** 2 for i in range(n))
    return num / den
