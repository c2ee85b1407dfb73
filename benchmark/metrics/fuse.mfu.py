"""fuse.mfu: the PointNet encoder's operations on the points actually fused
(points inside the bounds, x 8 corners, x 2 x the MLP's multiply-adds) over
the traced fuse time, as a share of the card's dense TF32 peak, in %."""


def read(ctx):
    spans = ctx.spans.get("fuse")
    stats = ctx.counters.get("frame_stats")
    if not spans or not stats:
        return None
    r = ctx.rooflines
    dims = r.layer_dims(ctx.run.config["network"])["encoder"]
    flops = sum(r.encoder_flops(s["inside"], dims) for s in stats)
    return 100.0 * flops / sum(spans) / r.PEAK_FLOPS
