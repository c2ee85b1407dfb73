"""fused_encode.roofline: kernels.fused_encode_sorted's least time on the
card (the larger of the encoder's operations on the points inside the
bounds, 8 corners each, at the dense TF32 peak, and the bytes those
points need: their inputs (offset and normal) read and their 8 x F
features written, plus the weights and biases once per frame) over its
device time in the trace (fused_encode_kernel), in %.  Every frame of the
traced scan; the points inside are counted by the reference, as fuse.mfu
counts them."""


def read(ctx):
    stats = ctx.counters.get("frame_stats")
    if ctx.timeline is None or not stats:
        return None
    dev_s, launches = ctx.timeline.device_time(("fused_encode_kernel",))
    if not launches or dev_s <= 0:
        return None
    r = ctx.rooflines
    net = ctx.run.config["network"]
    dims = r.layer_dims(net)["encoder"]
    fdim = int(net["feature_dims"])
    weights = r.macs(dims) + sum(dims[1:])
    bound = sum(r.bound_s(r.encoder_flops(s["inside"], dims),
                          4.0 * (s["inside"] * (dims[0] + 8 * fdim) +
                                 weights))
                for s in stats)
    return 100.0 * bound / dev_s
