"""fuse.ms_per_frame.k1: host time of the traced unit's table updates (each
call into NeuralMap.integrate_batch / integrate, from a synced start to a
synced end) per frame fused, in ms."""


def read(ctx):
    spans, n = ctx.spans.get("fuse"), ctx.counters.get("frames")
    if not spans or not n:
        return None
    return 1e3 * sum(spans) / n
