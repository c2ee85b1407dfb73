"""optimize.ms_per_iter.event: host time of the demo event's
NeuralMap.optimize (synced at both ends) per iteration, in ms."""


def read(ctx):
    spans, n = ctx.spans.get("optimize"), ctx.counters.get("iterations")
    if not spans or not n:
        return None
    return 1e3 * sum(spans) / n
