"""optimize.ms_per_iter.refine: host time of the refine job's
NeuralMap.optimize (synced at both ends) per iteration, in ms."""


def read(ctx):
    spans, n = ctx.spans.get("optimize"), ctx.counters.get("iterations")
    if not spans or not n:
        return None
    return 1e3 * sum(spans) / n
