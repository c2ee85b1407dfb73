"""What the fuse-path readers share.  bnv_fusion_tpu_torch names each
NeuralMap.integrate_batch / integrate call a ``fuse`` span and each of its
stages a ``fuse.<stage>`` span (utils/profiling.py): host ranges on the
profiler's clock, in the traced unit's timeline.  Each reader returns None
where the program makes no such span."""

import bisect

FRONT = ("fuse.stage", "fuse.points", "fuse.sort1", "fuse.encode",
         "fuse.reduce1", "fuse.corners", "fuse.sort2", "fuse.reduce2")
UPDATE = ("fuse.merge", "fuse.table", "fuse.overflow")
PRIOR = ("fuse.prior",)


def _ranges(ctx, names):
    t = ctx.timeline
    if t is None:
        return []
    return [(a, b) for n, a, b in t.host if n in names]


def host_syncs(ctx):
    """The CUDA runtime's host waits (``cu*Synchronize`` calls) that start
    inside a ``fuse`` span, per span: one table update in each stream
    cell."""
    fuse = sorted(_ranges(ctx, ("fuse",)))
    if not fuse:
        return None
    waits = sorted(a for n, a, _ in ctx.timeline.host
                   if n.startswith("cu") and n.endswith("Synchronize"))
    inside = sum(bisect.bisect_right(waits, b) - bisect.bisect_left(waits, a)
                 for a, b in fuse)
    return inside / len(fuse)


def _ms_per_frame(ctx, stages):
    spans, frames = _ranges(ctx, stages), ctx.counters.get("frames")
    if not spans or not frames:
        return None
    return sum(b - a for a, b in spans) / 1e3 / frames


def front_ms(ctx):
    return _ms_per_frame(ctx, FRONT)


def update_ms(ctx):
    return _ms_per_frame(ctx, UPDATE)


def prior_ms(ctx):
    return _ms_per_frame(ctx, PRIOR)
