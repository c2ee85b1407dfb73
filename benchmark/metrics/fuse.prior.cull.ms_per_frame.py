"""fuse.prior.cull.ms_per_frame: time on the profiler's clock inside the
block-major prior's ``fuse.prior.cull`` spans (the pose's inverse and the
frustum test of every brick; host ranges, waits for the card included) per
frame fused, over the traced unit, in ms."""

from benchmark.metrics._fuse_spans import _ms_per_frame


def read(ctx):
    return _ms_per_frame(ctx, ("fuse.prior.cull",))
